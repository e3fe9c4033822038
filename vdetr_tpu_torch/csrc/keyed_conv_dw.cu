// Weight gradient of the keyed 3x3x3 sparse convolution (Hopper).
//
// Replaces the TPU kernels vdetr_tpu/ops/sparse_conv_keyed.py:
// keyed_conv_dw (_keyed_dw_kernel, and _keyed_dw_kernel_g, the same
// function split into offset groups when the (27, C, Co) f32 accumulator
// outgrows VMEM). Function, over batch rows b, query rows v, offsets k:
//   nbr_k(b, v) = row of pack(q[b, v] + off[k]) in the sorted keys of
//                 b's input table (bounds check first; miss -> none),
//   dW[k] = sum_{b, v valid, hit} feats[b, nbr_k(b, v)]^T dout[b, v],
// f32, (27, C, Co). Its contract in the JAX package is jax.vjp of
// sparse_conv._gather_matmul over _zrun_neighbors with respect to W.
//
// The TPU kernels' window anchors, one-hot selection matmuls and VMEM
// group split exist because Mosaic cannot gather rows and VMEM is small;
// here a block gathers its rows directly and the accumulator lives in
// registers, so one kernel covers both.
//
// What bounds it on the H100: the multiply-adds, 2 * C * Co per (row,
// offset) hit (the deep 512-wide levels dominate), and, where C is small,
// the reads of dout. Only 36-43% of a deep level's rows hit a given
// offset (11% at the stem). Design (launch_dw in sparse_conv.cuh, shared
// with mapped_conv_dw.cu):
// - where 27 C fits one 96-row tile (the stem's C = 3), a first kernel
//   resolves every (offset, row) neighbour once by binary search into a
//   (27, B*V) map (-1 = miss or invalid row), and the GEMM block takes all
//   27 offsets of its rows: dW is one (27 C, Co) matrix, and dout is read
//   once instead of once per offset;
// - otherwise the first kernel builds the rulebook instead: per (offset,
//   row split) the ordered list of (input row, query row) pairs that hit,
//   by binary search and a block-wide scan (no atomics), and the GEMM
//   block, one per (offset, 64 x 64 dW tile, row split), walks its list,
//   hits only.
// The GEMM is split TF32 on the tensor cores (three m16n8k8 MMAs per f32
// product, each 32-row stage summed apart and added with f32 adds) behind
// a 3-deep cp.async ring. Where the tiles are too few to fill the card,
// the rows are split over blocks whose partial dW a last kernel adds in a
// fixed order. Every step is deterministic: two calls give the same bits.
//
// The bf16 form (keyed_conv_dw_bf16, compute_dtype="bfloat16"): the
// features bf16, dout f32 as the JAX package's cotangent, taken as its
// bf16 high and low halves (each product two bf16 products, ~2^-17 of
// it); C a multiple of 8 (the caller pads the stem's 3 channels). Its
// GEMM is sparse_conv_sm90.cuh's dw_bf16_kernel: the per-hit gathers of
// feature rows and f32 dout rows from L2 bound it (12 KB a hit at 512 ->
// 512 in 128 x 128 tiles), not the tensor cores, so a producer warpgroup
// keeps three 64-hit stages of cp.async gathers in flight behind a
// four-deep mbarrier ring, splits each stage's dout once for the block,
// and the consumer warpgroups run wgmma m64n64k16 with both operands read
// hit by hit from shared memory; 128 x 128 tiles where both widths exceed
// 64 halve the gathers each hit costs. The stem (8 channels) takes
// the dense form over the same (27, B*V) map as the f32 form's: its 27
// neighbours' 8 channels are dW's 216 rows, dout read once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_conv.cuh"

namespace {

using namespace sparse_conv;

// The neighbour of offset k of query row r = b * V + v, by binary search:
// b * V_in + its row in b's sorted keys, or -1
struct SearchMap {
  const int* in_keys;
  const int* q_coords;
  const uint8_t* q_valid;
  int V_in, V, gx, gy, gz;
  __device__ __forceinline__ int operator()(int k, int r) const {
    if (!q_valid[r]) return -1;
    const int* qc = q_coords + (size_t)r * 3;
    const int x = qc[0] + k / 9 - 1;
    const int y = qc[1] + (k / 3) % 3 - 1;
    const int z = qc[2] + k % 3 - 1;
    // bounds check first: an out-of-range neighbour must not alias a key
    // of the next x or y slice
    if (x < 0 || x >= gx || y < 0 || y >= gy || z < 0 || z >= gz) return -1;
    const int key = (x * gy + y) * gz + z;
    const int b = r / V;
    const int* keys = in_keys + (size_t)b * V_in;
    const int pos = lower_bound(keys, V_in, key);
    return (pos < V_in && keys[pos] == key) ? b * V_in + pos : -1;
  }
};

// nbr[k * rows + r] = search(k, r): the dense form's flat map
__global__ void neighbour_map_kernel(SearchMap search, int* __restrict__ nbr,
                                     int rows) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < (size_t)rows * KV; i += (size_t)gridDim.x * blockDim.x)
    nbr[i] = search((int)(i / rows), (int)(i % rows));
}

// One launch of either form; T the features' type.
template <typename T>
int launch(const void* feats, const void* in_keys, const void* q_coords,
           const void* q_valid, const void* dout, void* dw, void* nbr,
           void* scratch, int B, int V_in, int V, int C, int Co, int gx,
           int gy, int gz, int splits, int rows_per_split, void* stream) {
  const int rows = B * V;
  if (splits < 1 || rows_per_split % DW_BR != 0 ||
      (long long)splits * rows_per_split < rows)
    return (int)cudaErrorInvalidValue;
  if (C > 0 && Co > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const SearchMap search{(const int*)in_keys, (const int*)q_coords,
                           (const uint8_t*)q_valid, V_in, V, gx, gy, gz};
    if (dw_dense_form<T>(C) && rows > 0)
      neighbour_map_kernel<<<528, 256, 0, st>>>(search, (int*)nbr, rows);
    float* dst = splits > 1 ? (float*)scratch : (float*)dw;
    const cudaError_t err = launch_dw(
        (const T*)feats, (const float*)dout, search,
        FlatMap{(const int*)nbr, rows}, (int*)nbr, dst, rows, C, Co, splits,
        rows_per_split, st);
    if (err != cudaSuccess) return (int)err;
    if (splits > 1)
      dw_sum_splits(dst, (float*)dw, (size_t)KV * C * Co, splits, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// nbr: int32 scratch, the dense form's (27, B * V) map when 27 C <= 96,
// else the rulebook (dw_rulebook_ints(splits, rows_per_split) ints);
// scratch: (splits, 27, C, Co) floats when splits > 1, else unused.
// rows_per_split must be a multiple of 32.
extern "C" int keyed_conv_dw_f32(const void* feats, const void* in_keys,
                                 const void* q_coords, const void* q_valid,
                                 const void* dout, void* dw, void* nbr,
                                 void* scratch, int B, int V_in, int V,
                                 int C, int Co, int gx, int gy, int gz,
                                 int splits, int rows_per_split,
                                 void* stream) {
  return launch<float>(feats, in_keys, q_coords, q_valid, dout, dw, nbr,
                       scratch, B, V_in, V, C, Co, gx, gy, gz, splits,
                       rows_per_split, stream);
}

// The bf16 form: feats bf16 (C a multiple of 8), dout f32 (Co a multiple
// of 4), both 16-byte aligned; nbr the dense form's map when C == 8, else
// the rulebook; the rest as keyed_conv_dw_f32's.
extern "C" int keyed_conv_dw_bf16(const void* feats, const void* in_keys,
                                  const void* q_coords, const void* q_valid,
                                  const void* dout, void* dw, void* nbr,
                                  void* scratch, int B, int V_in, int V,
                                  int C, int Co, int gx, int gy, int gz,
                                  int splits, int rows_per_split,
                                  void* stream) {
  return launch<bf16>(feats, in_keys, q_coords, q_valid, dout, dw, nbr,
                      scratch, B, V_in, V, C, Co, gx, gy, gz, splits,
                      rows_per_split, stream);
}
