// Pieces shared by the vertex-RPE attention kernels (rpe_attention.cu,
// rpe_attention_bwd.cu, rpe_table_sum.cu): the log-quantized table index,
// the trilinear taps of a table index, the same-bits test of the shared
// x/y quantize, the attention-dropout hash, and the fixed-order sum of
// per-block slices. The plain PyTorch
// versions in vdetr_tpu_torch/ops/rpe_attention.py compute the same.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rpe {

// quant(d) = ((sign(d) log2(|d| log_scale + 1) / 3 / max_value + 1) n
// - 1) / 2: the continuous grid_sample index (align_corners=False)
__device__ __forceinline__ float quantize(float d, float log_scale,
                                          float max_value, int n) {
  const float mag = log2f(fabsf(d) * log_scale + 1.0f);
  const float s = d > 0.f ? mag : (d < 0.f ? -mag : 0.f);
  const float q = s / 3.0f / max_value;
  return ((q + 1.0f) * n - 1.0f) * 0.5f;
}

// Whether two floats are the same bits: corners i and i + 4 of a box
// differ in z alone, so their x and y quantizes may be done once
__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// Calls fn(cell, weight) for each in-range trilinear tap of the continuous
// table index (iw, ih, id) (quantize of the x, y, z delta); cell indexes
// the (d=z, h=y, w=x) table of n^3 cells, component 0 (x) the last axis,
// as torch grid_sample does.
template <typename Fn>
__device__ __forceinline__ void index_taps(float iw, float ih, float id,
                                           int n, Fn fn) {
  const float fw = floorf(iw), fh = floorf(ih), fd = floorf(id);
  const float ww = iw - fw, wh = ih - fh, wd = id - fd;
  const int cw0 = (int)fw, ch0 = (int)fh, cd0 = (int)fd;
#pragma unroll
  for (int dd = 0; dd < 2; ++dd) {
    const int cd = cd0 + dd;
    if (cd < 0 || cd >= n) continue;
    const float wdd = dd ? wd : 1.f - wd;
#pragma unroll
    for (int dh = 0; dh < 2; ++dh) {
      const int ch = ch0 + dh;
      if (ch < 0 || ch >= n) continue;
      const float wdh = wdd * (dh ? wh : 1.f - wh);
#pragma unroll
      for (int dw = 0; dw < 2; ++dw) {
        const int cw = cw0 + dw;
        if (cw < 0 || cw >= n) continue;
        fn((cd * n + ch) * n + cw, wdh * (dw ? ww : 1.f - ww));
      }
    }
  }
}

// Attention dropout: a counter-based hash of (seed, row, key) that the
// forward and the backward both evaluate, so the backward replays the
// forward's mask without storing it. row = (b * H + h) * nQ + q.
// keep iff (x >> 8) >= threshold, threshold = floor(rate * 2^24).
__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t row_hash(uint32_t seed, uint32_t row) {
  return hash32(seed ^ hash32(row));
}

__device__ __forceinline__ bool keep(uint32_t rowh, uint32_t key,
                                     uint32_t threshold) {
  return (hash32(rowh ^ (key * 0x9E3779B1u)) >> 8) >= threshold;
}

// out[i] = the slices of `parts` (slices x n floats) added in slice order,
// ((p_0 + p_1) + p_2) + ...: the same sum in every run. The caller's grid
// strides over the n outputs; `vec4`: n a multiple of 4 and both bases
// 16-byte aligned.
__device__ __forceinline__ void slices_sum(const float* __restrict__ parts,
                                           float* __restrict__ out, size_t n,
                                           int slices, bool vec4) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec4) {
    const float4* p4 = reinterpret_cast<const float4*>(parts);
    for (; i < n / 4; i += stride) {
      float4 s = p4[i];
      for (int z = 1; z < slices; ++z) {
        const float4 x = p4[z * (n / 4) + i];
        s.x += x.x;
        s.y += x.y;
        s.z += x.z;
        s.w += x.w;
      }
      reinterpret_cast<float4*>(out)[i] = s;
    }
    return;
  }
  for (; i < n; i += stride) {
    float s = parts[i];
#pragma unroll 8
    for (int z = 1; z < slices; ++z) s += parts[z * n + i];
    out[i] = s;
  }
}

}  // namespace rpe
