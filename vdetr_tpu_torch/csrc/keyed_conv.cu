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
// kernel feeds the MXU): the same kernel on bf16 features and weights,
// each product one mma.sync.m16n8k16 bf16 MMA into the f32 accumulators
// (exact products), the gathered rows and weight tiles half the bytes.
// It reads rows in 16-byte pieces: C and Co multiples of 8 (the caller
// pads the stem's 3 channels to 8).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_conv.cuh"

namespace {

using namespace sparse_conv;

template <typename T, int BK, int STAGES>
__global__ void __launch_bounds__(CONV_NT)
keyed_conv_kernel(const T* __restrict__ feats,       // (B, V_in, C)
                  const int* __restrict__ in_keys,   // (B, V_in) ascending
                  const int* __restrict__ q_coords,  // (B, V, 3)
                  const uint8_t* __restrict__ q_valid,  // (B, V)
                  const T* __restrict__ w,           // (27, C, Co)
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
  conv_tile<T, BK, STAGES>(feats + (size_t)b * V_in * C, w, s_nbr, k_begin,
                           nk, C, Co, n0, a16, b16, acc);
  store_tile(out + (size_t)b * V * Co, V, Co, m0, n0, acc);
}

// One launch of either form: the conv kernel into `out` or, with splits
// > 1, into `scratch`, then the fixed-order sum of the splits.
template <typename T>
int launch(const void* feats, const void* in_keys, const void* q_coords,
           const void* q_valid, const void* weights, void* out,
           void* scratch, int B, int V_in, int V, int C, int Co, int gx,
           int gy, int gz, int splits, void* stream) {
  if (splits < 1 || splits > KV) return (int)cudaErrorInvalidValue;
  constexpr int EPC = 16 / sizeof(T);
  const bool a16 = C % EPC == 0 && aligned16(feats);
  const bool b16 = Co % EPC == 0 && aligned16(weights);
  if (!is_f32<T>() && !(a16 && b16)) return (int)cudaErrorInvalidValue;
  if (B > 0 && V > 0 && Co > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    float* dst = splits > 1 ? (float*)scratch : (float*)out;
    dim3 grid((V + BM - 1) / BM, (Co + BN - 1) / BN, B * splits);
    // 32-channel stages two deep; the stem's 3 channels (8 in the bf16
    // form), whose one k step leaves little work to overlap, 16-channel
    // stages three deep
    auto kernel = C <= 8 ? keyed_conv_kernel<T, 16, 3>
                         : keyed_conv_kernel<T, 32, 2>;
    kernel<<<grid, CONV_NT, 0, st>>>(
        (const T*)feats, (const int*)in_keys, (const int*)q_coords,
        (const uint8_t*)q_valid, (const T*)weights, dst, V_in, V, C, Co, gx,
        gy, gz, splits, a16, b16);
    if (splits > 1) {
      const size_t n = (size_t)B * V * Co;
      conv_sum_splits(dst, (float*)out, n, splits, st);
    }
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
  return launch<float>(feats, in_keys, q_coords, q_valid, weights, out,
                       scratch, B, V_in, V, C, Co, gx, gy, gz, splits,
                       stream);
}

// The bf16 form: feats and weights bf16, C and Co multiples of 8 and both
// 16-byte aligned; out and scratch as keyed_conv_f32's.
extern "C" int keyed_conv_bf16(const void* feats, const void* in_keys,
                               const void* q_coords, const void* q_valid,
                               const void* weights, void* out, void* scratch,
                               int B, int V_in, int V, int C, int Co, int gx,
                               int gy, int gz, int splits, void* stream) {
  return launch<bf16>(feats, in_keys, q_coords, q_valid, weights, out,
                      scratch, B, V_in, V, C, Co, gx, gy, gz, splits, stream);
}
