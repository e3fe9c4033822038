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
// What bounds it on the H100: as kernel D (keyed_conv_dw.cu), whose
// design it shares (launch_dw in sparse_conv.cuh): where 27 C fits one
// tile (the stem) the GEMM blocks read the map directly and take all 27
// offsets of their rows; otherwise a first kernel compacts the map into
// the rulebook, each offset's ordered (input row, query row) hits per row
// split (no atomics), and the GEMM blocks walk it, hits only; split TF32
// on the tensor cores, partials of row splits added in a fixed order. On
// the same neighbours D and I run the same GEMM over the same lists, so
// they give the same bits. The bf16 form (mapped_conv_dw_bf16) is D's
// bf16 form over the map: sparse_conv_sm90.cuh's dw_bf16_kernel, bound by
// its per-hit gathers from L2, behind an mbarrier ring of 64-hit stages
// (keyed_conv_dw.cu says more), dense at the stem (C == 8) over the map's
// columns, so it too is bit-equal to D's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_conv.cuh"

using namespace sparse_conv;

namespace {

// One launch of either form; T the features' type.
template <typename T>
int launch(const void* feats, const void* nbr, const void* dout, void* dw,
           void* scratch, int B, int V_in, int V, int C, int Co, int splits,
           int rows_per_split, void* stream) {
  const int rows = B * V;
  if (splits < 1 || rows_per_split % DW_BR != 0 ||
      (long long)splits * rows_per_split < rows)
    return (int)cudaErrorInvalidValue;
  if (C > 0 && Co > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const BatchMap map{(const int*)nbr, V, V_in};
    // the rulebook starts 16-byte aligned, for its 16-byte copies
    const size_t part =
        splits > 1 ? ((size_t)splits * KV * C * Co + 3) / 4 * 4 : 0;
    float* dst = splits > 1 ? (float*)scratch : (float*)dw;
    const cudaError_t err = launch_dw(
        (const T*)feats, (const float*)dout, map, map,
        (int*)((float*)scratch + part), dst, rows, C, Co, splits,
        rows_per_split, st);
    if (err != cudaSuccess) return (int)err;
    if (splits > 1)
      dw_sum_splits(dst, (float*)dw, (size_t)KV * C * Co, splits, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: (splits, 27, C, Co) floats when splits > 1, then, from the
// next multiple of 4 floats and when 27 C > 96, the rulebook
// (dw_rulebook_ints(splits, rows_per_split) ints).
// rows_per_split must be a multiple of 32.
extern "C" int mapped_conv_dw_f32(const void* feats, const void* nbr,
                                  const void* dout, void* dw, void* scratch,
                                  int B, int V_in, int V, int C, int Co,
                                  int splits, int rows_per_split,
                                  void* stream) {
  return launch<float>(feats, nbr, dout, dw, scratch, B, V_in, V, C, Co,
                       splits, rows_per_split, stream);
}

// The bf16 form (D's, keyed_conv_dw.cu): feats bf16 (C a multiple of 8),
// dout f32 (Co a multiple of 4), both 16-byte aligned; scratch as
// mapped_conv_dw_f32's, the rulebook where C != 8.
extern "C" int mapped_conv_dw_bf16(const void* feats, const void* nbr,
                                   const void* dout, void* dw, void* scratch,
                                   int B, int V_in, int V, int C, int Co,
                                   int splits, int rows_per_split,
                                   void* stream) {
  return launch<bf16>(feats, nbr, dout, dw, scratch, B, V_in, V, C, Co,
                      splits, rows_per_split, stream);
}
