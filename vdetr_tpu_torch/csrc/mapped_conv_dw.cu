// Weight gradient of the 3x3x3 sparse convolution over a given neighbour
// map (Hopper).
//
// Replaces the TPU kernel vdetr_tpu/ops/sparse_conv_kernel.py:
// window_conv_dw (_dw_kernel). Function, over batch rows b, query rows v,
// offsets k:
//   dW[k] = sum_{b, v, nbr[b, k, v] in [0, V_in)} feats[b, nbr[b, k, v]]^T
//           dout[b, v],
// f32, (27, C, Co), nbr the (B, 27, V) map of kernel G (map_kernel.cu).
// Its contract in the JAX package is jax.vjp of sparse_conv._gather_matmul
// with respect to W.
//
// The TPU kernel re-gathers each tile's rows through the forward's
// one-hot window matmuls and carries the (27, C, Co) accumulator in VMEM
// across its sequential grid. Hopper's blocks run in parallel, so blocks
// own the reduction over rows instead.
//
// What bounds it on the H100: f32 multiply-adds on the CUDA cores,
// 2 * C * Co per (row, offset) hit; the deep 512-wide levels dominate.
// Design: kernel D's (keyed_conv_dw.cu), fed by the map instead of its
// own binary searches: `dw_kernel` in sparse_conv.cuh gives each block one
// offset and one 64 x 64 (C, Co) tile of dW, walks its rows 16 at a time
// (their map entries are consecutive, so the read is coalesced), skips
// groups with no hit, stages the gathered input rows and the matching
// dout rows in shared memory and accumulates a register-tiled f32
// outer-product sum. Where the tiles are too few to fill the card, the
// caller splits the rows until two waves of the 132 SMs have work, and a
// second kernel adds the partials in a fixed order: the result is
// deterministic. No tensor cores yet: the operands are f32, as in the
// plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_conv.cuh"

using namespace sparse_conv;

// scratch: (splits, 27, C, Co) floats when splits > 1, else unused.
// rows_per_split must be a multiple of 16.
extern "C" int mapped_conv_dw_f32(const void* feats, const void* nbr,
                                  const void* dout, void* dw, void* scratch,
                                  int B, int V_in, int V, int C, int Co,
                                  int splits, int rows_per_split,
                                  void* stream) {
  const int rows = B * V;
  if (splits < 1 || rows_per_split % BR != 0 ||
      (long long)splits * rows_per_split < rows)
    return (int)cudaErrorInvalidValue;
  if (C > 0 && Co > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    float* dst = splits > 1 ? (float*)scratch : (float*)dw;
    dw_kernel<<<dw_grid(C, Co, splits), NT, 0, st>>>(
        (const float*)feats, (const float*)dout,
        BatchMap{(const int*)nbr, V, V_in}, dst, rows, C, Co,
        rows_per_split);
    if (splits > 1)
      dw_sum_splits(dst, (float*)dw, (size_t)KV * C * Co, splits, st);
  }
  return (int)cudaGetLastError();
}
