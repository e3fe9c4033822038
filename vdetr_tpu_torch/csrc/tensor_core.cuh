// TF32 tensor-core and cp.async pieces (PTX, sm_80 and later), shared by
// the sparse-conv GEMMs (sparse_conv.cuh: conv_tile, dw_kernel) and the
// flash-RPE backward's pair kernel (rpe_attention_bwd.cu). An f32 product
// on the tensor cores is split TF32: each operand split into hi and lo
// (split_tf32) and multiplied in three m16n8k8 MMAs (mma_tf32), hi * lo
// and lo * hi first, then hi * hi, each stage's MMAs chained from 0 and
// the stage sums added with f32 adds. (The bf16 forms' products are
// wgmma's, sparse_conv_sm90.cuh.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// whether a pointer may be read in 16-byte pieces
inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// 16 bytes global -> shared, in flight until cp_wait; zero-filled when
// !pred (src-size 0: nothing is read, src need only be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo with hi = tf32(x), lo = tf32(x - hi), both rounded to
// nearest, ties away from zero: hi * hi' + hi * lo' + lo * hi' carries
// ~21 bits of each operand, the f32 product's ~24 less the dropped
// lo * lo' (~2^-22). Rounded in integer ops, adding half the range of the
// 13 dropped bits and clearing them: for a finite x these are the bits of
// cvt.rna.tf32.f32, which compiles to the same add and mask plus a compare
// and a select for inf and NaN, about twice the instructions. An inf or a
// NaN operand still makes the product NaN (inf - inf is a NaN lo).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// d = a (16 x 8, row-major) . b (8 x 8, column-major) + c, TF32 in, f32
// out; fragments as PTX lays them out for m16n8k8
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2],
                                         const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

}  // namespace tc
