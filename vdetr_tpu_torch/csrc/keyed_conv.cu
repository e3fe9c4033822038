// Keyed 3x3x3 sparse convolution over sorted packed voxel keys (Hopper).
//
// Replaces the TPU kernel vdetr_tpu/ops/sparse_conv_keyed.py:keyed_conv
// (_keyed_conv_kernel). Function, per batch row b, query row v, offset k:
//   key = pack(q[v] + off[k]) with pack_keys' bounds check (out of range
//         is a miss), off[k] x-major / z-fastest in {-1,0,1}^3;
//   nbr = binary search of key in the sorted keys of the input table;
//   out[v] = sum_k feats[nbr] @ W[k]   (a miss contributes 0), f32.
// Queries are the table's own coords (submanifold) or 2*out_coords in the
// input lattice (stride 2); invalid query rows give 0.
//
// The TPU kernel's window anchors, one-hot selection matmuls and fix-up
// plans exist only because Mosaic has no dynamic row gather; here a block
// gathers its neighbour rows directly.
//
// What bounds it on the H100: the multiply-adds (the 512-wide convs
// dominate; ~27*C*Co*2 flop per output row), then the gather of
// neighbour rows from L2/HBM. Design: one block per 64 query rows x 64
// output channels x a share of the 27 offsets; the block resolves its
// neighbour rows once (binary searches, all threads), skips offsets with
// no hit in the tile and tiles with no valid row, and runs the tile's
// gather-GEMM on the tensor cores (`conv_tile` in sparse_conv.cuh,
// shared with mapped_conv.cu): a cp.async ring of gathered rows (16-byte
// copies, zero-filled for misses) and weight tiles, 32-channel stages two
// deep (16-channel stages three deep for the stem's 3 channels), each
// f32 operand split into two TF32 halves and multiplied in three
// mma.sync.m16n8k8 (hi*hi + hi*lo + lo*hi, f32 accumulation), which keeps
// the f32 plain version's accuracy where one TF32 pass would not at
// K = 27 * 512. The CUDA-core version it replaced (64x64x16 f32 register
// tiles) ran at 5-9% of the f32 peak, bound by its shared-memory loads
// and the exposed gather latency. What holds this one back: a tile
// multiplies all 64 rows for every offset with a hit, and only 36-43% of
// those (row, offset) products have a neighbour (10% at the stem); and
// deep levels have few live tiles (10 of 64 at 512 channels, batch 1),
// so the caller splits the offsets over `splits` blocks
// (`ops.sparse_conv_kernel.conv_splits`), which write partial sums that a
// second kernel adds in a fixed order.
//
// The bf16 form (keyed_conv_bf16, compute_dtype="bfloat16", as the TPU
// kernel feeds the MXU) has its own body for Hopper, conv_tile_sm90
// (sparse_conv_sm90.cuh: wgmma behind a four-deep mbarrier ring of
// 64-channel stages, gathered rows by a producer warpgroup's cp.async,
// weight tiles by TMA), on 128 x 64 or 64 x 128 output tiles. Its binary
// searches run one per (dx, dy) group of three offsets, whose keys are
// consecutive, several in lockstep a thread (resolve_tile_ilp). It reads
// rows in 16-byte pieces: C and Co multiples of 8 (the caller pads the
// stem's 3 channels to 8, eight offsets to a stage). Its offset splits
// are its own (`conv_splits(C, bf16=True)`); a split's tile with no hit
// writes nothing, and a second kernel adds the live partials in a fixed
// order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_conv.cuh"
#include "sparse_conv_sm90.cuh"

namespace {

using namespace sparse_conv;

template <int BK, int STAGES>
__global__ void __launch_bounds__(CONV_NT)
keyed_conv_kernel(const float* __restrict__ feats,   // (B, V_in, C)
                  const int* __restrict__ in_keys,   // (B, V_in) ascending
                  const int* __restrict__ q_coords,  // (B, V, 3)
                  const uint8_t* __restrict__ q_valid,  // (B, V)
                  const float* __restrict__ w,       // (27, C, Co)
                  float* __restrict__ out,           // (splits, B, V, Co)
                  int V_in, int V, int C, int Co, int gx, int gy, int gz,
                  int splits, bool a16, bool b16) {
  __shared__ int s_nbr[KV][BM];

  const int B = gridDim.z / splits;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int k_begin = split * KV / splits;
  const int nk = (split + 1) * KV / splits - k_begin;
  out += (size_t)split * B * V * Co;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int* keys = in_keys + (size_t)b * V_in;

  // resolve the tile's neighbour rows for its offsets (-1 = miss)
  for (int i = threadIdx.x; i < nk * BM; i += CONV_NT) {
    const int kk = i / BM, m = i % BM;
    const int k = k_begin + kk;
    const int row = m0 + m;
    int idx = -1;
    if (row < V && q_valid[(size_t)b * V + row]) {
      const int* qc = q_coords + ((size_t)b * V + row) * 3;
      const int x = qc[0] + k / 9 - 1;
      const int y = qc[1] + (k / 3) % 3 - 1;
      const int z = qc[2] + k % 3 - 1;
      // bounds check first: an out-of-range neighbour must not alias a
      // key of the next x or y slice
      if (x >= 0 && x < gx && y >= 0 && y < gy && z >= 0 && z < gz) {
        const int key = (x * gy + y) * gz + z;
        const int pos = lower_bound(keys, V_in, key);
        if (pos < V_in && keys[pos] == key) idx = pos;
      }
    }
    s_nbr[kk][m] = idx;
  }
  __syncthreads();

  ConvAcc acc = {};
  conv_tile<BK, STAGES>(feats + (size_t)b * V_in * C, w, s_nbr, k_begin, nk,
                        C, Co, n0, a16, b16, acc);
  store_tile(out + (size_t)b * V * Co, V, Co, m0, n0, acc);
}

// The bf16 form's neighbour rows, over ROWS query rows (s_nbr[kk][m]: the
// input row of query row m0 + m for offset k_begin + kk, -1 for a miss or
// an invalid query row). The offsets k = 3 g + dz + 1 of one (dx, dy)
// group g have consecutive keys, so a row takes one binary search per
// group, for its lowest in-range z, and walks the sorted unique keys from
// there to the next two (at most two steps).
// A thread takes (group, row) items i = tid + NTH r (r < R) of the groups
// that meet the block's offsets and runs their searches in lockstep, each
// step's R key reads independent of each other (lower_bound: the first
// key >= the query).
template <int NTH, int ROWS, int R>
__device__ __forceinline__ void resolve_tile_ilp(
    int (*s_nbr)[ROWS], const int* __restrict__ keys,
    const int* __restrict__ q_coords, const uint8_t* __restrict__ q_valid,
    int b, int m0, int k_begin, int nk, int V_in, int V, int gx, int gy,
    int gz) {
  const int g0 = k_begin / 3;
  const int items = ((k_begin + nk - 1) / 3 - g0 + 1) * ROWS;
  int xy[R], z0[R], lo[R];  // xy: the group's key at z = 0, -1 for none
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + NTH * r;
    const int g = g0 + i / ROWS, row = m0 + i % ROWS;
    xy[r] = -1;
    z0[r] = 0;
    lo[r] = 0;
    if (i < items && row < V && q_valid[(size_t)b * V + row]) {
      const int* qc = q_coords + ((size_t)b * V + row) * 3;
      const int x = qc[0] + g / 3 - 1, y = qc[1] + g % 3 - 1;
      // bounds check first: an out-of-range neighbour must not alias a
      // key of the next x or y slice
      if (x >= 0 && x < gx && y >= 0 && y < gy) {
        xy[r] = (x * gy + y) * gz;
        z0[r] = qc[2];
      }
    }
  }
  // lo + n spans the candidates; keys[lo + half] < key moves lo up
  for (int n = V_in; n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (xy[r] >= 0 && keys[lo[r] + half] < xy[r] + max(z0[r] - 1, 0))
        lo[r] += half;
    n -= half;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + NTH * r;
    if (i >= items) break;
    const int g = g0 + i / ROWS, m = i % ROWS;
    int pos = lo[r];
    if (xy[r] >= 0 && V_in > 0 && keys[pos] < xy[r] + max(z0[r] - 1, 0))
      ++pos;
    for (int dz = -1; dz <= 1; ++dz) {
      const int z = z0[r] + dz, kk = 3 * g + dz + 1 - k_begin;
      int idx = -1;
      if (xy[r] >= 0 && z >= 0 && z < gz) {
        const int key = xy[r] + z;
        while (pos < V_in && keys[pos] < key) ++pos;
        if (pos < V_in && keys[pos] == key) idx = pos;
      }
      if (kk >= 0 && kk < nk) s_nbr[kk][m] = idx;
    }
  }
}

// The bf16 form: tiles of 64 MT rows x 64 NB channels
// (sparse_conv_sm90.cuh); the grid's x is (split, column tile), y the row
// tile, so that the row tiles start in order
template <int MT, int NB>
__global__ void __launch_bounds__(sparse_conv_sm90::threads<MT, NB>())
keyed_conv_bf16_kernel(const bf16* __restrict__ feats,    // (B, V_in, C)
                       const int* __restrict__ in_keys,   // (B, V_in)
                       const int* __restrict__ q_coords,  // (B, V, 3)
                       const uint8_t* __restrict__ q_valid,  // (B, V)
                       const __grid_constant__ CUtensorMap wmap,  // (27 C, Co)
                       float* __restrict__ out,  // (splits, B, V, Co)
                       int* __restrict__ flags,  // (splits, B, V / 64 MT)
                       int V_in, int V, int C, int Co, int gx, int gy,
                       int gz, int splits) {
  constexpr int NTH = sparse_conv_sm90::threads<MT, NB>(), ROWS = 64 * MT;
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

  resolve_tile_ilp<NTH, ROWS, (KV / 3 * ROWS + NTH - 1) / NTH>(
      s_nbr, in_keys + (size_t)b * V_in, q_coords, q_valid, b, m0, k_begin,
      nk, V_in, V, gx, gy, gz);
  __syncthreads();
  sparse_conv_sm90::conv_tile_sm90<MT, NB>(
      feats + (size_t)b * V_in * C, &wmap, s_nbr, k_begin, nk, C, Co,
      (blockIdx.x % ncol) * 64 * NB, m0, V, out + (size_t)b * V * Co,
      splits > 1 ? flags + ((size_t)split * B + b) * gridDim.y + blockIdx.y
                 : nullptr,
      smem);
}

// f32: the conv kernel into `out` or, with splits > 1, into `scratch`,
// then the fixed-order sum of the splits.
int launch_f32(const void* feats, const void* in_keys, const void* q_coords,
               const void* q_valid, const void* weights, void* out,
               void* scratch, int B, int V_in, int V, int C, int Co, int gx,
               int gy, int gz, int splits, void* stream) {
  if (splits < 1 || splits > KV) return (int)cudaErrorInvalidValue;
  const bool a16 = C % 4 == 0 && aligned16(feats);
  const bool b16 = Co % 4 == 0 && aligned16(weights);
  if (B > 0 && V > 0 && Co > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    float* dst = splits > 1 ? (float*)scratch : (float*)out;
    dim3 grid((V + BM - 1) / BM, (Co + BN - 1) / BN, B * splits);
    // 32-channel stages two deep; the stem's 3 channels, whose one k step
    // leaves little work to overlap, 16-channel stages three deep
    auto kernel = C <= 8 ? keyed_conv_kernel<16, 3>
                         : keyed_conv_kernel<32, 2>;
    kernel<<<grid, CONV_NT, 0, st>>>(
        (const float*)feats, (const int*)in_keys, (const int*)q_coords,
        (const uint8_t*)q_valid, (const float*)weights, dst, V_in, V, C, Co,
        gx, gy, gz, splits, a16, b16);
    if (splits > 1) {
      const size_t n = (size_t)B * V * Co;
      conv_sum_splits(dst, (float*)out, n, splits, st);
    }
  }
  return (int)cudaGetLastError();
}

// bf16: as launch_f32, the weights through a tensor map; tiles of 128
// rows x 64 channels where Co <= 64, else 64 x 128
int launch_bf16(const void* feats, const void* in_keys, const void* q_coords,
                const void* q_valid, const void* weights, void* out,
                void* scratch, int B, int V_in, int V, int C, int Co, int gx,
                int gy, int gz, int splits, void* stream) {
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
          keyed_conv_bf16_kernel<2, 1>, grid, cap, st, (const bf16*)feats,
          (const int*)in_keys, (const int*)q_coords, (const uint8_t*)q_valid,
          wmap, dst, flags, V_in, V, C, Co, gx, gy, gz, splits);
    else
      err = sparse_conv_sm90::launch_sm90<1, 2>(
          keyed_conv_bf16_kernel<1, 2>, grid, cap, st, (const bf16*)feats,
          (const int*)in_keys, (const int*)q_coords, (const uint8_t*)q_valid,
          wmap, dst, flags, V_in, V, C, Co, gx, gy, gz, splits);
    if (err != cudaSuccess) return (int)err;
    if (splits > 1)
      sparse_conv_sm90::conv_sum_live_splits_kernel<<<264, 512, 0, st>>>(
          dst, flags, (float*)out, B, V, Co, splits, rows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: (splits, B, V, Co) floats when splits > 1, else unused.
extern "C" int keyed_conv_f32(const void* feats, const void* in_keys,
                              const void* q_coords, const void* q_valid,
                              const void* weights, void* out, void* scratch,
                              int B, int V_in, int V, int C, int Co, int gx,
                              int gy, int gz, int splits, void* stream) {
  return launch_f32(feats, in_keys, q_coords, q_valid, weights, out, scratch,
                    B, V_in, V, C, Co, gx, gy, gz, splits, stream);
}

// The bf16 form: feats and weights bf16, C and Co multiples of 8 and both
// 16-byte aligned; out and scratch as keyed_conv_f32's.
extern "C" int keyed_conv_bf16(const void* feats, const void* in_keys,
                               const void* q_coords, const void* q_valid,
                               const void* weights, void* out, void* scratch,
                               int B, int V_in, int V, int C, int Co, int gx,
                               int gy, int gz, int splits, void* stream) {
  return launch_bf16(feats, in_keys, q_coords, q_valid, weights, out,
                     scratch, B, V_in, V, C, Co, gx, gy, gz, splits, stream);
}
