// Fused vertex-RPE cross-attention forward (Hopper).
//
// Replaces the TPU kernel vdetr_tpu/ops/rpe_attention.py:
// rpe_cross_attention_pallas (_kernel); contract:
// rpe_cross_attention_reference. For query q (H heads, pre-scaled) and a
// single shared K/V head:
//   logit[h, q, k] = q[q, h] . K[k] + sum_{c<8} T_c(quant(R(corner[q, c]
//                                                      - key_xyz[k])))[h]
//   masked keys -> -1e9, softmax over k, out[q, h] = sum_k p * V[k].
// quant(d) = ((sign(d) log2(|d| log_scale + 1) / 3 / max_value + 1) n
// - 1) / 2 per component; T_c is the (d=z, h=y, w=x, H) table of corner
// c sampled trilinearly with zero padding (torch grid_sample,
// align_corners=False: component 0 indexes the last table axis). R is
// the optional object-frame rotation by the query's angle.
//
// Training form (the flash backward, rpe_attention_bwd.cu, consumes it):
// attention dropout after the softmax, p -> p * keep / (1 - rate), on the
// numerator only, as the Pallas kernel applies it; keep comes from the
// counter hash of rpe_common.cuh, which the backward replays. Optional
// outputs: the row log-sum-exp (0 for a batch row whose keys are all
// masked) and the masked biased logits, which the backward reads instead
// of recomputing the bias (the JAX package's train forward stores them
// too, rpe_attention.py:663-673).
//
// The TPU kernel's hat-product P matrices, paired-corner table layout and
// its reliance on corners i, i+4 sharing x/y exist only because Mosaic has
// no dynamic gather. Here each corner is sampled with 8 direct reads from
// the tables in shared memory, for any corners.
//
// What bounds it on the H100: the bias, 8 corners x 8 taps of H floats
// per (query, key) pair read from shared memory (~4x the flops of the
// QK^T and PV products at H = 4, hd = 64). Design: one block per (batch,
// 8 queries); all 8 * n^3 * H table values (128 KB at n = 10, H = 4) sit
// in dynamic shared memory for the block's whole sweep over the keys; per
// 64-key tile the block stages K, V and key positions in shared memory,
// computes the tile's bias for all heads at once (one float4 read per tap
// when H = 4), and four threads per (query, head) row form the logits,
// run the streaming softmax and accumulate P.V in registers. K and V are
// read once per tile for all H heads. Keys past nK get weight exactly 0;
// masked keys get -1e9, so a fully masked row averages V uniformly, as in
// the reference.

#include "rpe_common.cuh"

namespace {

constexpr int H = 4;              // heads (the published model's 4)
constexpr int TQ = 8;             // queries per block
constexpr int TK = 64;            // keys per tile
constexpr int TPR = 4;            // threads per (query, head) row
constexpr int NT = TQ * H * TPR;  // 128 threads

// Training outputs of the forward; every pointer may be null.
struct TrainOut {
  float* lse;              // (B, nQ, H) row log-sum-exp
  float* logits;           // (B, H, nQ, nK) masked biased logits
  const long long* seed;   // device scalar; null: no dropout
  uint32_t threshold;      // keep iff hash >> 8 >= threshold
  float scale;             // 1 / (1 - rate)
};

template <int HD>
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
      dropout ? rpe::row_hash((uint32_t)*train.seed,
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
      const int pq = p / TK, pk = p % TK;
      const float kx = s_kxyz[pk * 3 + 0];
      const float ky = s_kxyz[pk * 3 + 1];
      const float kz = s_kxyz[pk * 3 + 2];
      const float co = s_cs[pq * 2 + 0], si = s_cs[pq * 2 + 1];
      float4 bias = make_float4(0.f, 0.f, 0.f, 0.f);
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
        const float4* tc = s_tab + (size_t)c * n3;
        rpe::corner_taps(dx, dy, dz, log_scale, max_value, n,
                         [&](int cell, float wt) {
                           const float4 t = tc[cell];
                           bias.x += wt * t.x;
                           bias.y += wt * t.y;
                           bias.z += wt * t.z;
                           bias.w += wt * t.w;
                         });
      }
      s_bias[pq * TK + pk] = bias;
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
          dropout ? (rpe::keep(rowh, (uint32_t)(k0 + kk), train.threshold)
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
}

template <int HD>
int launch(const float* q, const float* k, const float* v,
           const float* corners, const float* cossin, const float* key_xyz,
           const float* tables, const uint8_t* key_valid, float* out,
           TrainOut train, int B, int nQ, int nK, int n, float log_scale,
           float max_value, cudaStream_t stream) {
  const size_t n3 = (size_t)n * n * n;
  const size_t smem = 8 * n3 * sizeof(float4) +
                      (2 * TK * HD + TQ * TK * H + TK * 4 + TQ * 26) *
                          sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rpe_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nQ + TQ - 1) / TQ, B);
  rpe_attention_kernel<HD><<<grid, NT, smem, stream>>>(
      q, k, v, corners, cossin, key_xyz, tables, key_valid, out, train, nQ,
      nK, n, log_scale, max_value);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaErrorInvalidValue (1) for a head count or head width the
// kernel is not built for; the Python wrapper checks both first. lse,
// logits and seed may be null (eval: none of them); a null seed means no
// dropout.
extern "C" int rpe_cross_attention_f32(
    const void* q, const void* k, const void* v, const void* corners,
    const void* cossin, const void* key_xyz, const void* tables,
    const void* key_valid, void* out, void* lse, void* logits,
    const void* seed, int B, int nQ, int nK, int heads, int hd, int n,
    float log_scale, float max_value, int rotate, int keep_threshold,
    float drop_scale, void* stream) {
  if (heads != H) return (int)cudaErrorInvalidValue;
  if (B <= 0 || nQ <= 0 || nK <= 0) return (int)cudaGetLastError();
  const float* cs = rotate ? (const float*)cossin : nullptr;
  const TrainOut train{(float*)lse, (float*)logits, (const long long*)seed,
                       (uint32_t)keep_threshold, drop_scale};
  auto args = [&](auto fn) {
    return fn((const float*)q, (const float*)k, (const float*)v,
              (const float*)corners, cs, (const float*)key_xyz,
              (const float*)tables, (const uint8_t*)key_valid, (float*)out,
              train, B, nQ, nK, n, log_scale, max_value,
              (cudaStream_t)stream);
  };
  switch (hd) {
    case 8: return args(launch<8>);
    case 16: return args(launch<16>);
    case 32: return args(launch<32>);
    case 64: return args(launch<64>);
    case 128: return args(launch<128>);
    default: return (int)cudaErrorInvalidValue;
  }
}
