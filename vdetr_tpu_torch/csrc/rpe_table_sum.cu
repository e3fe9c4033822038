// The flash-RPE backward's dTables: the table kernel's slices added in a
// fixed order (Hopper).
//
// Part of the port of the TPU kernel vdetr_tpu/ops/rpe_attention.py:
// _flash_bwd_impl (the dTables output of _bwd_kernel_a). The table kernel
// of rpe_attention_bwd.cu writes one slice of the 8 tables per (batch
// row, 32-query tile, key share): its sums over the pairs it took, exact
// in 64-bit fixed point inside the block. Function:
//   dtables[i] = ((slice_0[i] + slice_1[i]) + slice_2[i]) + ...
// in slice order, so dTables is the same bits in every run; the atomics
// that once added the blocks' tables in their order of arrival are gone.
// What bounds it: the bytes (the slices read once, dtables written
// once: 8.2 MB at the published shape, ~2.5 us at 3.35 TB/s); the slices
// were just written, so they are read from L2. One thread per table word
// walks the slices in order: 32000 words fill the card's SMs, where four
// words a thread (the dq sum's form) left three quarters of them idle
// and ran 1.5x slower than torch.sum (PERF.md §6).

#include <cuda_runtime.h>

#include "rpe_common.cuh"

namespace {

constexpr int SMS = 132;  // the H100 SXM's SMs

__global__ void __launch_bounds__(256)
rpe_table_sum_kernel(const float* __restrict__ slices,
                     float* __restrict__ dtables, size_t n, int count) {
  rpe::slices_sum(slices, dtables, n, count, false);
}

}  // namespace

// dtables (n floats) = the `count` slices (count x n floats) added in
// slice order.
extern "C" int rpe_table_sum_f32(const void* slices, void* dtables, int n,
                                 int count, void* stream) {
  if (n <= 0 || count <= 0) return (int)cudaGetLastError();
  const int blocks = (n + 255) / 256 < SMS * 8 ? (n + 255) / 256 : SMS * 8;
  rpe_table_sum_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)slices, (float*)dtables, (size_t)n, count);
  return (int)cudaGetLastError();
}
