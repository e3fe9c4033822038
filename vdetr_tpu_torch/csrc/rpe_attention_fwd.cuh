// The forward body of the vertex-RPE cross-attention (kernel C), templated
// on the bias it adds to the logits. rpe_attention.cu instantiates the full
// bias (BIAS_FULL): kernel C, whose source note states the function, the
// bound and the design. rpe_ablate.cu instantiates the stage ablation's
// levels 0-5 (the probe of tools/rpe_ablate.py). Every level runs C's grid,
// block, shared-memory footprint and K/V/key/table staging; only the bias
// of each (query, key) pair, summed over the 8 corners, differs:
//   0  none: flash attention alone
//   1  v1 = dx + dy + dz                                       (all heads)
//   2  v2 = quant(dx) + quant(dy) + quant(dz)                  (all heads)
//   3  v3 = hat_0(quant dz) + hat_0(quant dy) + hat_0(quant dx) (all heads)
//   4  v4 = hat_0(quant dz) * hat_0(quant dy)                  (all heads)
//   5  v5 = sum_{z,y} T_c[z, y, 0, h] hat_z(quant dz) hat_y(quant dy)
//   6  the trilinear sample T_c(quant(d))[h]: kernel C
// with d = corner_c - key per axis (rotated when asked), quant the
// continuous table index of rpe_common.cuh and hat_i(x) = max(1 - |i - x|,
// 0), which is the linear-interpolation tap weight of lattice point i.
// Levels 1-5 nest: level L also computes v1 .. v(L-1) and keeps them live
// (below), so its time minus level L-1's is the cost of the work it adds.
// Level 6 (C) is not built on level 5: it computes no v1-v4 sums and hats,
// and adds the x axis's floor and the four taps off the x = 0 plane.
#pragma once

#include "rpe_common.cuh"

namespace rpe {

constexpr int H = 4;              // heads (the published model's 4)
constexpr int TQ = 8;             // queries per block
constexpr int TK = 64;            // keys per tile
constexpr int TPR = 4;            // threads per (query, head) row
constexpr int NT = TQ * H * TPR;  // 128 threads

enum BiasLevel : int {
  BIAS_NONE = 0,
  BIAS_DELTAS = 1,
  BIAS_QUANT = 2,
  BIAS_HAT0 = 3,
  BIAS_HAT0_ZY = 4,
  BIAS_PLANE_X0 = 5,
  BIAS_FULL = 6,
};

// Training outputs of the forward; every pointer may be null.
struct TrainOut {
  float* lse;              // (B, nQ, H) row log-sum-exp
  float* logits;           // (B, H, nQ, nK) masked biased logits
  const long long* seed;   // device scalar; null: no dropout
  uint32_t threshold;      // keep iff hash >> 8 >= threshold
  float scale;             // 1 / (1 - rate)
};

__device__ __forceinline__ float hat0(float x) {
  return fmaxf(1.f - fabsf(x), 0.f);
}

__device__ __forceinline__ void add_all_heads(float4& b, float x) {
  b.x += x;
  b.y += x;
  b.z += x;
  b.w += x;
}

// Adds one corner's bias of level LEVEL (table above) for the delta
// (dx, dy, dz) to the four heads of `bias`; tc is the corner's table. The
// lower levels' values are added to `live`, which only a store that never
// runs reads (end of rpe_attention_kernel): the compiler keeps their work,
// and the bias is the level's own value alone.
template <int LEVEL>
__device__ __forceinline__ void corner_bias(float4& bias, float& live,
                                            float dx, float dy, float dz,
                                            const float4* tc, float log_scale,
                                            float max_value, int n) {
  if constexpr (LEVEL == BIAS_FULL) {
    corner_taps(dx, dy, dz, log_scale, max_value, n,
                [&](int cell, float wt) {
                  const float4 t = tc[cell];
                  bias.x += wt * t.x;
                  bias.y += wt * t.y;
                  bias.z += wt * t.z;
                  bias.w += wt * t.w;
                });
  } else {
    const float v1 = dx + dy + dz;
    if constexpr (LEVEL == BIAS_DELTAS) {
      add_all_heads(bias, v1);
      return;
    }
    live += v1;
    const float iw = quantize(dx, log_scale, max_value, n);
    const float ih = quantize(dy, log_scale, max_value, n);
    const float id = quantize(dz, log_scale, max_value, n);
    const float v2 = iw + ih + id;
    if constexpr (LEVEL == BIAS_QUANT) {
      add_all_heads(bias, v2);
      return;
    }
    live += v2;
    const float v3 = hat0(id) + hat0(ih) + hat0(iw);
    if constexpr (LEVEL == BIAS_HAT0) {
      add_all_heads(bias, v3);
      return;
    }
    live += v3;
    const float v4 = hat0(id) * hat0(ih);
    if constexpr (LEVEL == BIAS_HAT0_ZY) {
      add_all_heads(bias, v4);
      return;
    }
    live += v4;
    // level 5: the bilinear taps of (z, y) in the x = 0 plane of the table
    const float fh = floorf(ih), fd = floorf(id);
    const float wh = ih - fh, wd = id - fd;
    const int ch0 = (int)fh, cd0 = (int)fd;
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      const int cd = cd0 + dd;
      if (cd < 0 || cd >= n) continue;
      const float wdd = dd ? wd : 1.f - wd;
#pragma unroll
      for (int dh = 0; dh < 2; ++dh) {
        const int ch = ch0 + dh;
        if (ch < 0 || ch >= n) continue;
        const float wt = wdd * (dh ? wh : 1.f - wh);
        const float4 t = tc[(cd * n + ch) * n];
        bias.x += wt * t.x;
        bias.y += wt * t.y;
        bias.z += wt * t.z;
        bias.w += wt * t.w;
      }
    }
  }
}

template <int HD, int LEVEL>
__global__ void __launch_bounds__(NT)
rpe_attention_kernel(const float* __restrict__ q,        // (B, nQ, H, HD)
                     const float* __restrict__ k,        // (B, nK, HD)
                     const float* __restrict__ v,        // (B, nK, HD)
                     const float* __restrict__ corners,  // (B, nQ, 8, 3)
                     const float* __restrict__ cossin,   // (B, nQ, 2) or null
                     const float* __restrict__ key_xyz,  // (B, nK, 3)
                     const float* __restrict__ tables,   // (8, n, n, n, H)
                     const uint8_t* __restrict__ key_valid,  // (B, nK) or null
                     float* __restrict__ out,            // (B, nQ, H, HD)
                     TrainOut train, int nQ, int nK, int n, float log_scale,
                     float max_value) {
  constexpr int DPT = HD / TPR;  // dims per thread, strided by TPR
  extern __shared__ float4 smem4[];
  const int n3 = n * n * n;
  float4* s_tab = smem4;                                   // 8 * n3
  float* s_k = reinterpret_cast<float*>(smem4 + 8 * n3);   // TK * HD
  float* s_v = s_k + TK * HD;                              // TK * HD
  float4* s_bias = reinterpret_cast<float4*>(s_v + TK * HD);  // TQ * TK
  float* s_kxyz = reinterpret_cast<float*>(s_bias + TQ * TK);  // TK * 3
  float* s_kmask = s_kxyz + TK * 3;  // TK: 1 valid, 0 masked, -1 past nK
  float* s_corner = s_kmask + TK;    // TQ * 24
  float* s_cs = s_corner + TQ * 24;  // TQ * 2

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR, g = tid % TPR;
  const int ql = row / H, h = row % H;
  const int qi = q0 + ql;
  const bool rotate = cossin != nullptr;
  const bool dropout = train.seed != nullptr;
  const uint32_t rowh =
      dropout ? row_hash((uint32_t)*train.seed,
                         (uint32_t)((b * H + h) * nQ + qi))
              : 0u;

  const float4* tab4 = reinterpret_cast<const float4*>(tables);
  for (int i = tid; i < 8 * n3; i += NT) s_tab[i] = tab4[i];
  for (int i = tid; i < TQ * 24; i += NT) {
    const int qq = q0 + i / 24;
    s_corner[i] = qq < nQ ? corners[((size_t)b * nQ + qq) * 24 + i % 24] : 0.f;
  }
  for (int i = tid; i < TQ * 2; i += NT) {
    const int qq = q0 + i / 2;
    s_cs[i] = (rotate && qq < nQ) ? cossin[((size_t)b * nQ + qq) * 2 + i % 2]
                                  : 0.f;
  }
  // a batch row with no valid key averages V; its lse is written as 0
  int any_valid = key_valid == nullptr;
  if (train.lse != nullptr && !any_valid) {
    for (int i = tid; i < nK; i += NT)
      any_valid |= key_valid[(size_t)b * nK + i] != 0;
  }
  any_valid = __syncthreads_or(any_valid);

  float qr[DPT], acc[DPT];
  const float* qrow = q + (((size_t)b * nQ + (qi < nQ ? qi : 0)) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = qrow[g + TPR * i];
    acc[i] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;
  float live = 0.f;  // the lower ablation levels' values (corner_bias)
  float* lrow = train.logits == nullptr || qi >= nQ ? nullptr
      : train.logits + (((size_t)b * H + h) * nQ + qi) * nK;

  const float* kb = k + (size_t)b * nK * HD;
  const float* vb = v + (size_t)b * nK * HD;
  for (int k0 = 0; k0 < nK; k0 += TK) {
    __syncthreads();  // previous tile fully consumed (and smem init done)
    for (int i = tid; i < TK * HD; i += NT) {
      const int kk = k0 + i / HD;
      s_k[i] = kk < nK ? kb[(size_t)k0 * HD + i] : 0.f;
      s_v[i] = kk < nK ? vb[(size_t)k0 * HD + i] : 0.f;
    }
    for (int i = tid; i < TK; i += NT) {
      const int kk = k0 + i;
      float mk = -1.f;
      if (kk < nK) mk = (key_valid == nullptr ||
                         key_valid[(size_t)b * nK + kk]) ? 1.f : 0.f;
      s_kmask[i] = mk;
      for (int c = 0; c < 3; ++c)
        s_kxyz[i * 3 + c] =
            kk < nK ? key_xyz[((size_t)b * nK + kk) * 3 + c] : 0.f;
    }
    __syncthreads();

    // bias for the tile's TQ x TK pairs, all H heads at once
    for (int p = tid; p < TQ * TK; p += NT) {
      float4 bias = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (LEVEL != BIAS_NONE) {
        const int pq = p / TK, pk = p % TK;
        const float kx = s_kxyz[pk * 3 + 0];
        const float ky = s_kxyz[pk * 3 + 1];
        const float kz = s_kxyz[pk * 3 + 2];
        const float co = s_cs[pq * 2 + 0], si = s_cs[pq * 2 + 1];
        for (int c = 0; c < 8; ++c) {
          const float* cc = s_corner + pq * 24 + c * 3;
          float dx = cc[0] - kx, dy = cc[1] - ky;
          const float dz = cc[2] - kz;
          if (rotate) {
            const float rx = dx * co - dy * si;
            const float ry = dx * si + dy * co;
            dx = rx;
            dy = ry;
          }
          corner_bias<LEVEL>(bias, live, dx, dy, dz,
                             s_tab + (size_t)c * n3, log_scale, max_value, n);
        }
      }
      s_bias[p] = bias;
    }
    __syncthreads();

    // logits of this thread's (query, head) row over the tile
    float s[TK];
    float m_tile = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * s_k[kk * HD + g + TPR * i];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const float4 bv = s_bias[ql * TK + kk];
      const float bh = h == 0 ? bv.x : h == 1 ? bv.y : h == 2 ? bv.z : bv.w;
      const float mk = s_kmask[kk];
      const float lg = mk > 0.f ? part + bh : (mk == 0.f ? -1e9f : -INFINITY);
      s[kk] = lg;
      m_tile = fmaxf(m_tile, lg);
      // the row's four threads write every fourth key
      if (lrow != nullptr && (kk & (TPR - 1)) == g && mk >= 0.f)
        lrow[k0 + kk] = lg;
    }
    const float m_new = fmaxf(m_run, m_tile);
    const float alpha = expf(m_run - m_new);
    float l_tile = 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float p = expf(s[kk] - m_new);
      l_tile += p;
      // dropout scales the numerator only: the softmax denominator never
      // sees it (post-softmax dropout)
      const float pv =
          dropout ? (keep(rowh, (uint32_t)(k0 + kk), train.threshold)
                         ? p * train.scale : 0.f)
                  : p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += pv * s_v[kk * HD + g + TPR * i];
    }
    l_run = l_run * alpha + l_tile;
    m_run = m_new;
  }

  if (qi < nQ) {
    float* orow = out + (((size_t)b * nQ + qi) * H + h) * HD;
    const float inv = 1.f / l_run;
#pragma unroll
    for (int i = 0; i < DPT; ++i) orow[g + TPR * i] = acc[i] * inv;
    if (train.lse != nullptr && g == 0)
      train.lse[((size_t)b * nQ + qi) * H + h] =
          any_valid ? m_run + logf(l_run) : 0.f;
  }
  // the lower levels' values are finite and small: their sum is never
  // NaN, so this store never runs
  if constexpr (LEVEL >= BIAS_QUANT && LEVEL <= BIAS_PLANE_X0)
    if (isnan(live)) out[0] = live;
}

// Sets the kernel's shared-memory allowance and launches it on `stream`;
// returns cudaGetLastError().
template <int HD, int LEVEL>
int launch_forward(const float* q, const float* k, const float* v,
                   const float* corners, const float* cossin,
                   const float* key_xyz, const float* tables,
                   const uint8_t* key_valid, float* out, TrainOut train,
                   int B, int nQ, int nK, int n, float log_scale,
                   float max_value, cudaStream_t stream) {
  const size_t n3 = (size_t)n * n * n;
  const size_t smem = 8 * n3 * sizeof(float4) +
                      (2 * TK * HD + TQ * TK * H + TK * 4 + TQ * 26) *
                          sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rpe_attention_kernel<HD, LEVEL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nQ + TQ - 1) / TQ, B);
  rpe_attention_kernel<HD, LEVEL><<<grid, NT, smem, stream>>>(
      q, k, v, corners, cossin, key_xyz, tables, key_valid, out, train, nQ,
      nK, n, log_scale, max_value);
  return (int)cudaGetLastError();
}

}  // namespace rpe
