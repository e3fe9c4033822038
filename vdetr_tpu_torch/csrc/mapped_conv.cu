// 3x3x3 sparse convolution over a given neighbour map (Hopper).
//
// Replaces the TPU kernel vdetr_tpu/ops/sparse_conv_kernel.py:window_conv
// (_conv_kernel). Function, per batch row b, query row v, offset k:
//   out[b, v] = sum_k feats[b, nbr[b, k, v]] @ W[k], f32, where an entry
//   outside [0, V_in) (the map's miss, V_in) contributes 0.
// The map is kernel G's (map_kernel.cu): a level's own sites for a
// submanifold conv, 2 * out_coords for a stride-2 conv, so rows of invalid
// queries, all misses, give 0. Its contract in the JAX package is
// sparse_conv._gather_matmul.
//
// The TPU kernel consumes the map as window anchors, window-local `le`
// indices and one-hot selection matmuls on bf16 (build_window_map),
// because Mosaic cannot gather rows, and patches the rows its windows do
// not cover. Here a block gathers feats[nbr] directly, in f32.
//
// What bounds it on the H100: the multiply-adds, 2 * C * Co per (row,
// offset) hit (the 512-wide convs dominate), then the gather of
// neighbour rows from L2/HBM. Design: kernel A's (keyed_conv.cu) with
// its binary searches replaced by a coalesced read of the tile's map
// columns: one block per 64 query rows x 64 output channels x a share of
// the 27 offsets stages the map in shared memory, skips offsets with no
// hit in the tile (so tiles with no valid row), and runs A's split-TF32
// tensor-core gather-GEMM behind a cp.async ring (`conv_tile` in
// sparse_conv.cuh), so H and A are bit-equal. As for A, the caller
// splits the offsets over `splits` blocks from 64 input channels
// (`ops.sparse_conv_kernel.conv_splits`), whose partial sums a second
// kernel adds in a fixed order. The bf16 form (mapped_conv_bf16) is A's
// bf16 form over the map: the map's columns, then conv_tile_sm90
// (sparse_conv_sm90.cuh: wgmma behind an mbarrier ring), bit-equal to
// keyed_conv_bf16.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_conv.cuh"
#include "sparse_conv_sm90.cuh"

namespace {

using namespace sparse_conv;

// s_nbr[kk][m] = the map's entry of query row m0 + m (m < ROWS) for
// offset k_begin + kk, -1 for a miss; NTH threads of the block
template <int NTH, int ROWS = BM>
__device__ __forceinline__ void map_tile(int (*s_nbr)[ROWS],
                                         const int* __restrict__ nbr, int b,
                                         int m0, int k_begin, int nk,
                                         int V_in, int V) {
  for (int i = threadIdx.x; i < nk * ROWS; i += NTH) {
    const int kk = i / ROWS, m = i % ROWS;
    const int row = m0 + m;
    int idx = -1;
    if (row < V) {
      const int r = nbr[((size_t)b * KV + k_begin + kk) * V + row];
      if (r >= 0 && r < V_in) idx = r;
    }
    s_nbr[kk][m] = idx;
  }
}

template <int BK, int STAGES>
__global__ void __launch_bounds__(CONV_NT)
mapped_conv_kernel(const float* __restrict__ feats,  // (B, V_in, C)
                   const int* __restrict__ nbr,      // (B, 27, V)
                   const float* __restrict__ w,      // (27, C, Co)
                   float* __restrict__ out,          // (splits, B, V, Co)
                   int V_in, int V, int C, int Co, int splits, bool a16,
                   bool b16) {
  __shared__ int s_nbr[KV][BM];

  const int B = gridDim.z / splits;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int k_begin = split * KV / splits;
  const int nk = (split + 1) * KV / splits - k_begin;
  out += (size_t)split * B * V * Co;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the tile's map columns for its offsets (-1 = miss)
  map_tile<CONV_NT>(s_nbr, nbr, b, m0, k_begin, nk, V_in, V);
  __syncthreads();

  ConvAcc acc = {};
  conv_tile<BK, STAGES>(feats + (size_t)b * V_in * C, w, s_nbr, k_begin, nk,
                        C, Co, n0, a16, b16, acc);
  store_tile(out + (size_t)b * V * Co, V, Co, m0, n0, acc);
}

// The bf16 form: keyed_conv_bf16_kernel's tiles and grid over the map
template <int MT, int NB>
__global__ void __launch_bounds__(sparse_conv_sm90::threads<MT, NB>())
mapped_conv_bf16_kernel(const bf16* __restrict__ feats,  // (B, V_in, C)
                        const int* __restrict__ nbr,     // (B, 27, V)
                        const __grid_constant__ CUtensorMap wmap,  // (27C, Co)
                        float* __restrict__ out,  // (splits, B, V, Co)
                        int* __restrict__ flags,  // (splits, B, V / 64 MT)
                        int V_in, int V, int C, int Co, int splits) {
  constexpr int ROWS = 64 * MT;
  extern __shared__ uint8_t smem[];
  __shared__ int s_nbr[KV][ROWS];

  const int B = gridDim.z;
  const int b = blockIdx.z;
  const int ncol = gridDim.x / splits;
  const int split = blockIdx.x / ncol;
  const int k_begin = split * KV / splits;
  const int nk = (split + 1) * KV / splits - k_begin;
  out += (size_t)split * B * V * Co;
  const int m0 = blockIdx.y * ROWS;

  map_tile<sparse_conv_sm90::threads<MT, NB>(), ROWS>(
      s_nbr, nbr, b, m0, k_begin, nk, V_in, V);
  __syncthreads();
  sparse_conv_sm90::conv_tile_sm90<MT, NB>(
      feats + (size_t)b * V_in * C, &wmap, s_nbr, k_begin, nk, C, Co,
      (blockIdx.x % ncol) * 64 * NB, m0, V, out + (size_t)b * V * Co,
      splits > 1 ? flags + ((size_t)split * B + b) * gridDim.y + blockIdx.y
                 : nullptr,
      smem);
}

// f32 (keyed_conv.cu's launch_f32 over a map)
int launch_f32(const void* feats, const void* nbr, const void* weights,
               void* out, void* scratch, int B, int V_in, int V, int C,
               int Co, int splits, void* stream) {
  if (splits < 1 || splits > KV) return (int)cudaErrorInvalidValue;
  const bool a16 = C % 4 == 0 && aligned16(feats);
  const bool b16 = Co % 4 == 0 && aligned16(weights);
  if (B > 0 && V > 0 && Co > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    float* dst = splits > 1 ? (float*)scratch : (float*)out;
    dim3 grid((V + BM - 1) / BM, (Co + BN - 1) / BN, B * splits);
    // kernel A's choice of stage width and depth (keyed_conv.cu)
    auto kernel = C <= 8 ? mapped_conv_kernel<16, 3>
                         : mapped_conv_kernel<32, 2>;
    kernel<<<grid, CONV_NT, 0, st>>>(
        (const float*)feats, (const int*)nbr, (const float*)weights, dst,
        V_in, V, C, Co, splits, a16, b16);
    if (splits > 1)
      conv_sum_splits(dst, (float*)out, (size_t)B * V * Co, splits, st);
  }
  return (int)cudaGetLastError();
}

// bf16 (keyed_conv.cu's launch_bf16 over a map)
int launch_bf16(const void* feats, const void* nbr, const void* weights,
                void* out, void* scratch, int B, int V_in, int V, int C,
                int Co, int splits, void* stream) {
  if (splits < 1 || splits > KV) return (int)cudaErrorInvalidValue;
  if (C % 8 || Co % 8 || !aligned16(feats) || !aligned16(weights))
    return (int)cudaErrorInvalidValue;
  if (B > 0 && V > 0 && Co > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    float* dst = splits > 1 ? (float*)scratch : (float*)out;
    // the splits' live flags after their partials
    int* flags = (int*)((float*)scratch + (size_t)splits * B * V * Co);
    CUtensorMap wmap;
    cudaError_t err = sparse_conv_sm90::weight_map(weights, C, Co, &wmap);
    if (err != cudaSuccess) return (int)err;
    const int cap = sparse_conv_sm90::live_cap(C, splits);
    const bool tall = Co <= 64;
    const int rows = tall ? 128 : 64, cols = tall ? 64 : 128;
    dim3 grid((Co + cols - 1) / cols * splits, (V + rows - 1) / rows, B);
    if (tall)
      err = sparse_conv_sm90::launch_sm90<2, 1>(
          mapped_conv_bf16_kernel<2, 1>, grid, cap, st, (const bf16*)feats,
          (const int*)nbr, wmap, dst, flags, V_in, V, C, Co, splits);
    else
      err = sparse_conv_sm90::launch_sm90<1, 2>(
          mapped_conv_bf16_kernel<1, 2>, grid, cap, st, (const bf16*)feats,
          (const int*)nbr, wmap, dst, flags, V_in, V, C, Co, splits);
    if (err != cudaSuccess) return (int)err;
    if (splits > 1)
      sparse_conv_sm90::conv_sum_live_splits_kernel<<<264, 512, 0, st>>>(
          dst, flags, (float*)out, B, V, Co, splits, rows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: (splits, B, V, Co) floats when splits > 1, else unused.
extern "C" int mapped_conv_f32(const void* feats, const void* nbr,
                               const void* weights, void* out, void* scratch,
                               int B, int V_in, int V, int C, int Co,
                               int splits, void* stream) {
  return launch_f32(feats, nbr, weights, out, scratch, B, V_in, V, C, Co,
                    splits, stream);
}

// The bf16 form: feats and weights bf16, C and Co multiples of 8 and both
// 16-byte aligned.
extern "C" int mapped_conv_bf16(const void* feats, const void* nbr,
                                const void* weights, void* out, void* scratch,
                                int B, int V_in, int V, int C, int Co,
                                int splits, void* stream) {
  return launch_bf16(feats, nbr, weights, out, scratch, B, V_in, V, C, Co,
                     splits, stream);
}
