// Pieces shared by the vertex-RPE attention kernels (rpe_attention.cu,
// rpe_attention_bwd.cu): the log-quantized table index, the trilinear
// taps of a table index, the same-bits test of the shared x/y quantize,
// and the attention-dropout hash. The plain PyTorch
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

}  // namespace rpe
