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
// and adds the x axis's floor and the four taps off the x = 0 plane. At
// every level from 2, corners i and i + 4 whose x and y agree bit for bit
// quantize x and y once (box corners; the probe's random corners do not).
#pragma once

#include "rpe_common.cuh"

namespace rpe {

constexpr int H = 4;               // heads (the published model's 4)
constexpr int TQ = 8;              // queries per block
constexpr int TPR = 4;             // threads per (query, head) row
constexpr int GT = TQ * H * TPR;   // threads per key group: 128
constexpr int MAX_GROUPS = 4;      // key groups per block
constexpr int ROWS = TQ * H;       // (query, head) rows per block

// keys per tile of one group: 2048 / HD (32 at HD = 64), at most 64, so
// that four groups' K and V tiles take 64 KB beside the tables
template <int HD>
__host__ __device__ constexpr int tile_keys() {
  return HD >= 32 ? 2048 / HD : 64;
}

// floats of one key group's staging: K and V tiles, the bias tile (TQ x
// TK float4), key positions and mask; after the sweep the same space
// holds the group's (m, l, acc) per row for the merge
template <int HD>
__host__ __device__ constexpr int group_floats() {
  return 2 * tile_keys<HD>() * HD + 4 * TQ * tile_keys<HD>() +
         4 * tile_keys<HD>();
}

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
  uint32_t key_offset;     // global index of key 0 (a key shard's), which
                           // the dropout hash reads
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

// the 128 threads of key group `grp` wait for each other (named barrier
// 1 + grp; barrier 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "r"(GT) : "memory");
}

// Adds one corner's bias of level LEVEL (table above) to the four heads of
// `bias`: (dx, dy, dz) is the delta (rotated), (iw, ih, id) its quantize
// (read from level 2 on), tc the corner's table. The lower levels' values
// are added to `live`, which only a store that never runs reads (end of
// rpe_attention_kernel): the compiler keeps their work, and the bias is
// the level's own value alone.
template <int LEVEL>
__device__ __forceinline__ void corner_bias(float4& bias, float& live,
                                            float dx, float dy, float dz,
                                            float iw, float ih, float id,
                                            const float4* tc, int n) {
  if constexpr (LEVEL == BIAS_FULL) {
    index_taps(iw, ih, id, n, [&](int cell, float wt) {
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

// The bias of one (query, key) pair, all heads: the 8 corners in pairs
// (i, i + 4); `pair_xy` says the pair's x and y agree bit for bit, so
// their (rotated) x and y deltas and quantizes are computed once.
template <int LEVEL>
__device__ __forceinline__ float4 pair_bias(
    float& live, const float* corners, const int* pair_xy, float kx,
    float ky, float kz, bool rotate, float co, float si, const float4* tab,
    int n3, float log_scale, float max_value, int n) {
  float4 bias = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (LEVEL != BIAS_NONE) {
    auto delta_xy = [&](const float* c, float& dx, float& dy) {
      dx = c[0] - kx;
      dy = c[1] - ky;
      if (rotate) {
        const float rx = dx * co - dy * si;
        const float ry = dx * si + dy * co;
        dx = rx;
        dy = ry;
      }
    };
#pragma unroll
    for (int cp = 0; cp < 4; ++cp) {
      const float* ca = corners + cp * 3;
      const float* cb = ca + 12;
      const bool shared = pair_xy[cp] != 0;
      float dxa, dya, dxb, dyb;
      delta_xy(ca, dxa, dya);
      if (shared) {
        dxb = dxa;
        dyb = dya;
      } else {
        delta_xy(cb, dxb, dyb);
      }
      const float dza = ca[2] - kz, dzb = cb[2] - kz;
      float iwa = 0.f, iha = 0.f, ida = 0.f, iwb = 0.f, ihb = 0.f, idb = 0.f;
      if constexpr (LEVEL >= BIAS_QUANT) {
        iwa = quantize(dxa, log_scale, max_value, n);
        iha = quantize(dya, log_scale, max_value, n);
        if (shared) {
          iwb = iwa;
          ihb = iha;
        } else {
          iwb = quantize(dxb, log_scale, max_value, n);
          ihb = quantize(dyb, log_scale, max_value, n);
        }
        ida = quantize(dza, log_scale, max_value, n);
        idb = quantize(dzb, log_scale, max_value, n);
      }
      corner_bias<LEVEL>(bias, live, dxa, dya, dza, iwa, iha, ida,
                         tab + (size_t)cp * n3, n);
      corner_bias<LEVEL>(bias, live, dxb, dyb, dzb, iwb, ihb, idb,
                         tab + (size_t)(cp + 4) * n3, n);
    }
  }
  return bias;
}

// One block per (batch row, TQ queries), ng key groups of GT threads. Each
// group sweeps its own key tiles (g, g + ng, g + 2 ng, ... of TK keys)
// with its own staging and named barriers, and keeps its own streaming
// softmax (m, l, acc) per (query, head) row; at the end the groups' states
// are merged in group order, so the result is the same on every call.
template <int HD, int LEVEL>
__global__ void __launch_bounds__(MAX_GROUPS * GT, 1)
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
  constexpr int TK = tile_keys<HD>();
  constexpr int GS = group_floats<HD>();
  static_assert(ROWS * (HD + 2) <= GS, "the merge fits a group's staging");
  extern __shared__ float4 smem4[];
  const int n3 = n * n * n;
  const int ng = blockDim.x / GT;
  float4* s_tab = smem4;                                    // 8 * n3
  float* s_grp = reinterpret_cast<float*>(smem4 + 8 * n3);  // ng * GS
  float* s_corner = s_grp + ng * GS;                        // TQ * 24
  float* s_cs = s_corner + TQ * 24;                         // TQ * 2
  int* s_pair = reinterpret_cast<int*>(s_cs + TQ * 2);      // TQ * 4

  const int tid = threadIdx.x;
  const int grp = tid / GT, gt = tid % GT;
  float* s_k = s_grp + grp * GS;                            // TK * HD
  float* s_v = s_k + TK * HD;                               // TK * HD
  float4* s_bias = reinterpret_cast<float4*>(s_v + TK * HD);  // TQ * TK
  float* s_kxyz = reinterpret_cast<float*>(s_bias + TQ * TK);  // TK * 3
  float* s_kmask = s_kxyz + TK * 3;  // TK: 1 valid, 0 masked, -1 past nK

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int row = gt / TPR, g = gt % TPR;
  const int ql = row / H, h = row % H;
  const int qi = q0 + ql;
  const bool rotate = cossin != nullptr;
  const bool dropout = train.seed != nullptr;
  const uint32_t rowh =
      dropout ? row_hash((uint32_t)*train.seed,
                         (uint32_t)((b * H + h) * nQ + qi))
              : 0u;

  const float4* tab4 = reinterpret_cast<const float4*>(tables);
  for (int i = tid; i < 8 * n3; i += blockDim.x) s_tab[i] = tab4[i];
  for (int i = tid; i < TQ * 24; i += blockDim.x) {
    const int qq = q0 + i / 24;
    s_corner[i] = qq < nQ ? corners[((size_t)b * nQ + qq) * 24 + i % 24] : 0.f;
  }
  for (int i = tid; i < TQ * 2; i += blockDim.x) {
    const int qq = q0 + i / 2;
    s_cs[i] = (rotate && qq < nQ) ? cossin[((size_t)b * nQ + qq) * 2 + i % 2]
                                  : 0.f;
  }
  // a batch row with no valid key averages V; its lse is written as 0
  int any_valid = key_valid == nullptr;
  if (train.lse != nullptr && !any_valid) {
    for (int i = tid; i < nK; i += blockDim.x)
      any_valid |= key_valid[(size_t)b * nK + i] != 0;
  }
  __syncthreads();  // the corners are staged
  for (int i = tid; i < TQ * 4; i += blockDim.x) {
    const float* c = s_corner + (i / 4) * 24 + (i % 4) * 3;
    s_pair[i] = same_bits(c[0], c[12]) && same_bits(c[1], c[13]);
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
  for (int k0 = grp * TK; k0 < nK; k0 += ng * TK) {
    group_sync(grp);  // the group's previous tile fully consumed
    for (int i = gt; i < TK * HD; i += GT) {
      const int kk = k0 + i / HD;
      s_k[i] = kk < nK ? kb[(size_t)k0 * HD + i] : 0.f;
      s_v[i] = kk < nK ? vb[(size_t)k0 * HD + i] : 0.f;
    }
    for (int i = gt; i < TK; i += GT) {
      const int kk = k0 + i;
      float mk = -1.f;
      if (kk < nK) mk = (key_valid == nullptr ||
                         key_valid[(size_t)b * nK + kk]) ? 1.f : 0.f;
      s_kmask[i] = mk;
      for (int c = 0; c < 3; ++c)
        s_kxyz[i * 3 + c] =
            kk < nK ? key_xyz[((size_t)b * nK + kk) * 3 + c] : 0.f;
    }
    group_sync(grp);

    // bias for the tile's TQ x TK pairs, all H heads at once
    for (int p = gt; p < TQ * TK; p += GT) {
      const int pq = p / TK, pk = p % TK;
      s_bias[p] = pair_bias<LEVEL>(
          live, s_corner + pq * 24, s_pair + pq * 4, s_kxyz[pk * 3 + 0],
          s_kxyz[pk * 3 + 1], s_kxyz[pk * 3 + 2], rotate, s_cs[pq * 2 + 0],
          s_cs[pq * 2 + 1], s_tab, n3, log_scale, max_value, n);
    }
    group_sync(grp);

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
          dropout ? (keep(rowh, (uint32_t)(k0 + kk) + train.key_offset,
                          train.threshold)
                         ? p * train.scale : 0.f)
                  : p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += pv * s_v[kk * HD + g + TPR * i];
    }
    l_run = l_run * alpha + l_tile;
    m_run = m_new;
  }

  // merge the groups' states in group order (every group's staging is
  // free once all groups are past the sweep)
  __syncthreads();
  float* mine = s_grp + grp * GS + row * (HD + 2);
  if (g == 0) {
    mine[0] = m_run;
    mine[1] = l_run;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) mine[2 + g + TPR * i] = acc[i];
  __syncthreads();
  if (grp == 0 && qi < nQ) {
    float m_all = -INFINITY;
    for (int gg = 0; gg < ng; ++gg)
      m_all = fmaxf(m_all, s_grp[gg * GS + row * (HD + 2)]);
    float l_all = 0.f, o[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[i] = 0.f;
    for (int gg = 0; gg < ng; ++gg) {
      const float* st = s_grp + gg * GS + row * (HD + 2);
      // a group without keys has m = -inf, l = 0 and weighs 0
      const float w = st[0] == -INFINITY ? 0.f : expf(st[0] - m_all);
      l_all += w * st[1];
#pragma unroll
      for (int i = 0; i < DPT; ++i) o[i] += w * st[2 + g + TPR * i];
    }
    float* orow = out + (((size_t)b * nQ + qi) * H + h) * HD;
    const float inv = 1.f / l_all;
#pragma unroll
    for (int i = 0; i < DPT; ++i) orow[g + TPR * i] = o[i] * inv;
    if (train.lse != nullptr && g == 0)
      train.lse[((size_t)b * nQ + qi) * H + h] =
          any_valid ? m_all + logf(l_all) : 0.f;
  }
  // the lower levels' values are finite and small: their sum is never
  // NaN, so this store never runs
  if constexpr (LEVEL >= BIAS_QUANT && LEVEL <= BIAS_PLANE_X0)
    if (isnan(live)) out[0] = live;
}

// Shared-memory bytes of a block of `groups` key groups.
template <int HD>
size_t forward_smem(int n, int groups) {
  return 8 * (size_t)n * n * n * sizeof(float4) +
         ((size_t)groups * group_floats<HD>() + TQ * 24 + TQ * 2 + TQ * 4) *
             sizeof(float);
}

// Launches the kernel on `stream` with as many key groups (up to
// MAX_GROUPS) as the card's shared memory holds beside the tables; returns
// cudaGetLastError().
template <int HD, int LEVEL>
int launch_forward(const float* q, const float* k, const float* v,
                   const float* corners, const float* cossin,
                   const float* key_xyz, const float* tables,
                   const uint8_t* key_valid, float* out, TrainOut train,
                   int B, int nQ, int nK, int n, float log_scale,
                   float max_value, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int groups = MAX_GROUPS;
  while (groups > 1 && forward_smem<HD>(n, groups) > (size_t)optin) --groups;
  const size_t smem = forward_smem<HD>(n, groups);
  err = cudaFuncSetAttribute(rpe_attention_kernel<HD, LEVEL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nQ + TQ - 1) / TQ, B);
  rpe_attention_kernel<HD, LEVEL><<<grid, groups * GT, smem, stream>>>(
      q, k, v, corners, cossin, key_xyz, tables, key_valid, out, train, nQ,
      nK, n, log_scale, max_value);
  return (int)cudaGetLastError();
}

}  // namespace rpe
