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
// What bounds it on the H100: f32 multiply-adds on the CUDA cores,
// 2 * C * Co per (row, offset) hit; the deep 512-wide levels dominate.
// Design: a first kernel resolves every (offset, row) neighbour once by
// binary search into a (27, B*V) map (-1 = miss or invalid row). The
// GEMM kernel gives each block one offset and one 64 x 64 (C, Co) tile of
// dW, so the 512 -> 512 conv has 27 * 64 blocks even though only ~80 of
// its 64-row tiles hold valid voxels at batch 1; the block walks its rows
// 16 at a time, skips groups with no hit, stages the gathered input rows
// and the matching dout rows in shared memory and accumulates a 64 x 64
// register-tiled f32 outer-product sum (`dw_kernel` in sparse_conv.cuh,
// shared with mapped_conv_dw.cu). Where the tiles are too few to
// fill the card (the stem and the 64-wide levels, 27 tiles), the rows are
// split over `splits` blocks whose partial dW a second kernel adds in a
// fixed order: the result is deterministic. No tensor cores yet: the
// operands are f32, as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_conv.cuh"

namespace {

using namespace sparse_conv;

// nbr[k, b * V + v] = b * V_in + row of the neighbour, or -1
__global__ void neighbour_map_kernel(const int* __restrict__ in_keys,
                                     const int* __restrict__ q_coords,
                                     const uint8_t* __restrict__ q_valid,
                                     int* __restrict__ nbr, int B, int V_in,
                                     int V, int gx, int gy, int gz) {
  const size_t rows = (size_t)B * V;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < rows * KV; i += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(i / rows);
    const size_t r = i % rows;
    const int b = (int)(r / V);
    int idx = -1;
    if (q_valid[r]) {
      const int* qc = q_coords + r * 3;
      const int x = qc[0] + k / 9 - 1;
      const int y = qc[1] + (k / 3) % 3 - 1;
      const int z = qc[2] + k % 3 - 1;
      // bounds check first: an out-of-range neighbour must not alias a
      // key of the next x or y slice
      if (x >= 0 && x < gx && y >= 0 && y < gy && z >= 0 && z < gz) {
        const int key = (x * gy + y) * gz + z;
        const int* keys = in_keys + (size_t)b * V_in;
        const int pos = lower_bound(keys, V_in, key);
        if (pos < V_in && keys[pos] == key) idx = b * V_in + pos;
      }
    }
    nbr[i] = idx;
  }
}

}  // namespace

// nbr: (27, B * V) int32 scratch; scratch: (splits, 27, C, Co) floats
// when splits > 1, else unused. rows_per_split must be a multiple of 16.
extern "C" int keyed_conv_dw_f32(const void* feats, const void* in_keys,
                                 const void* q_coords, const void* q_valid,
                                 const void* dout, void* dw, void* nbr,
                                 void* scratch, int B, int V_in, int V,
                                 int C, int Co, int gx, int gy, int gz,
                                 int splits, int rows_per_split,
                                 void* stream) {
  const int rows = B * V;
  if (splits < 1 || rows_per_split % BR != 0 ||
      (long long)splits * rows_per_split < rows)
    return (int)cudaErrorInvalidValue;
  if (C > 0 && Co > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (rows > 0) {
      neighbour_map_kernel<<<528, 256, 0, st>>>(
          (const int*)in_keys, (const int*)q_coords,
          (const uint8_t*)q_valid, (int*)nbr, B, V_in, V, gx, gy, gz);
    }
    float* dst = splits > 1 ? (float*)scratch : (float*)dw;
    dw_kernel<<<dw_grid(C, Co, splits), NT, 0, st>>>(
        (const float*)feats, (const float*)dout,
        FlatMap{(const int*)nbr, rows}, dst, rows, C, Co, rows_per_split);
    if (splits > 1)
      dw_sum_splits(dst, (float*)dw, (size_t)KV * C * Co, splits, st);
  }
  return (int)cudaGetLastError();
}
