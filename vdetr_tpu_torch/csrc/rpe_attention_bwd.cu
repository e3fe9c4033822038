// Flash backward of the vertex-RPE cross-attention (Hopper).
//
// Replaces the TPU kernel vdetr_tpu/ops/rpe_attention.py:_flash_bwd_impl
// (_bwd_kernel_a); contract: jax.vjp of rpe_cross_attention_reference
// with respect to q, K, V and the tables. From the training forward of
// rpe_attention.cu it reads the masked biased logits l and the row
// log-sum-exp, and it replays that forward's dropout mask g (the counter
// hash of rpe_common.cuh). With e = softmax probabilities, D = rowsum(dO
// * O) and dp = dO . V[k]:
//   ds[h, q, k] = e * (g * dp - D) at valid keys, 0 at masked keys (their
//                 logit is the constant -1e9);
//   eg[h, q, k] = e * g;
//   dQ[q, h]    = sum_k ds * K[k];
//   dT_c[cell, h] += w_tap(c, q, k) * ds[h, q, k] over the trilinear taps
//                 of every corner, as the forward sampled them.
// A batch row whose keys are all masked attends uniformly: there e = 1/nK
// and ds = 0. ds and eg are written out; dK = sum_h ds^T Q and dV =
// sum_h eg^T dO are two batched matrix products outside the kernel, as in
// the JAX package (rpe_attention.py:626-631). Corners, angles and key
// positions get no gradient: the decoder feeds detached boxes.
//
// What bounds it on the H100: the dTables scatter, 8 corners x 8 taps x H
// per (query, key) pair, then the dO.V and ds.K products; both are
// latency-bound unless many warps are resident. The TPU kernel builds
// hat-product matrices and accumulates dTables in a VMEM block the
// sequential grid carries. Here two kernels run back to back:
// - the pair kernel forms dp, ds, eg and dQ: one block per (batch, 8
//   queries, share of the keys), four threads per (query, head) row,
//   64-key tiles of K, V, key positions and logits staged in shared
//   memory (~57 KB, so three blocks fit an SM); the key shares add their
//   dQ with atomics; ds and eg leave through shared memory in coalesced
//   rows. The stored logits spare the bias recompute.
// - the table kernel scatters dTables from ds: one block per (batch, 32
//   queries, corner) keeps that corner's table (16 KB at n = 10, H = 4)
//   in shared memory and adds its nonzero entries to the global dTables
//   with one atomic add each at the end. The log quantization sends many
//   keys of a query to the same cells, so a thread-per-pair scatter
//   serializes on same-address atomics (several times slower on the
//   card); instead each lane quantizes one (pair, corner) item
//   and the warp walks its active items: for each, its 32 lanes take the
//   8 taps x 4 heads, 32 distinct words in 32 distinct banks.

#include "rpe_common.cuh"

namespace {

constexpr int H = 4;              // heads (the published model's 4)
constexpr int TQ = 8;             // queries per pair block
constexpr int TK = 64;            // keys per tile
constexpr int TPR = 4;            // threads per (query, head) row
constexpr int NT = TQ * H * TPR;  // 128 threads
constexpr int TQ2 = 32;           // queries per table block
constexpr int NT2 = 256;          // threads per table block

struct Dropout {
  const long long* seed;  // device scalar; null: no dropout
  uint32_t threshold;
  float scale;
};

template <int HD>
__global__ void __launch_bounds__(NT)
rpe_pair_bwd_kernel(
    const float* __restrict__ k,        // (B, nK, HD)
    const float* __restrict__ v,        // (B, nK, HD)
    const uint8_t* __restrict__ key_valid,  // (B, nK) or null
    const float* __restrict__ out,      // (B, nQ, H, HD)
    const float* __restrict__ dout,     // (B, nQ, H, HD)
    const float* __restrict__ logits,   // (B, H, nQ, nK)
    const float* __restrict__ lse,      // (B, nQ, H)
    float* __restrict__ dq,             // (B, nQ, H, HD), zeroed
    float* __restrict__ ds_out,         // (B, H, nQ, nK)
    float* __restrict__ eg_out,         // (B, H, nQ, nK)
    Dropout drop, int nQ, int nK, int keys_per_block) {
  constexpr int DPT = HD / TPR;
  extern __shared__ float smem[];
  float* s_k = smem;                     // TK * HD
  float* s_v = s_k + TK * HD;            // TK * HD
  float* s_ds = s_v + TK * HD;           // TQ * TK * H: ds, (pair, head)
  float* s_eg = s_ds + TQ * TK * H;      // TQ * TK * H: eg, (pair, head)
  float* s_l = s_eg + TQ * TK * H;       // TQ * H * TK: logits, (row, key)
  float* s_kmask = s_l + TQ * H * TK;    // TK: 1 valid, 0 masked, -1 past

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int kbeg = blockIdx.z * keys_per_block;
  const int kend = min(nK, kbeg + keys_per_block);
  const int tid = threadIdx.x;
  const int row = tid / TPR, g = tid % TPR;
  const int ql = row / H, h = row % H;
  const int qi = q0 + ql;
  const bool qvalid = qi < nQ;
  const bool dropout = drop.seed != nullptr;
  const uint32_t rowh =
      dropout ? rpe::row_hash((uint32_t)*drop.seed,
                              (uint32_t)((b * H + h) * nQ + qi))
              : 0u;

  int any_valid = key_valid == nullptr;
  if (!any_valid) {
    for (int i = tid; i < nK; i += NT)
      any_valid |= key_valid[(size_t)b * nK + i] != 0;
  }
  any_valid = __syncthreads_or(any_valid);
  const float uniform = any_valid ? 0.f : 1.f / nK;

  // this row's dO, D = dO . O and lse
  float dor[DPT], dqa[DPT];
  const size_t qrow = (((size_t)b * nQ + (qvalid ? qi : 0)) * H + h) * HD;
  float D = 0.f;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    dor[i] = qvalid ? dout[qrow + g + TPR * i] : 0.f;
    D += dor[i] * (qvalid ? out[qrow + g + TPR * i] : 0.f);
    dqa[i] = 0.f;
  }
  D += __shfl_xor_sync(0xffffffffu, D, 1);
  D += __shfl_xor_sync(0xffffffffu, D, 2);
  const float lse_r =
      qvalid ? lse[((size_t)b * nQ + qi) * H + h] : 0.f;

  const float* kb = k + (size_t)b * nK * HD;
  const float* vb = v + (size_t)b * nK * HD;
  for (int k0 = kbeg; k0 < kend; k0 += TK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < TK * HD; i += NT) {
      const int kk = k0 + i / HD;
      s_k[i] = kk < kend ? kb[(size_t)k0 * HD + i] : 0.f;
      s_v[i] = kk < kend ? vb[(size_t)k0 * HD + i] : 0.f;
    }
    for (int i = tid; i < TK; i += NT) {
      const int kk = k0 + i;
      float mk = -1.f;
      if (kk < kend) mk = (key_valid == nullptr ||
                           key_valid[(size_t)b * nK + kk]) ? 1.f : 0.f;
      s_kmask[i] = mk;
    }
    // logits tile: rows (h, q) of 64 contiguous keys
    for (int i = tid; i < TQ * H * TK; i += NT) {
      const int r = i / TK, kk = i % TK;
      const int hh = r / TQ, qq = r % TQ;
      const int qg = q0 + qq, kg = k0 + kk;
      s_l[(qq * H + hh) * TK + kk] =
          (qg < nQ && kg < kend)
              ? logits[(((size_t)b * H + hh) * nQ + qg) * nK + kg] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) dp += dor[i] * s_v[kk * HD + g + TPR * i];
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const float mk = s_kmask[kk];
      float e = 0.f;
      if (qvalid && mk > 0.f) e = expf(s_l[row * TK + kk] - lse_r);
      else if (qvalid && mk == 0.f) e = uniform;
      const float gs =
          dropout ? (rpe::keep(rowh, (uint32_t)(k0 + kk), drop.threshold)
                         ? drop.scale : 0.f)
                  : 1.f;
      const float ds = mk > 0.f ? e * (gs * dp - D) : 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) dqa[i] += ds * s_k[kk * HD + g + TPR * i];
      if (g == 0) {
        s_ds[(ql * TK + kk) * H + h] = ds;
        s_eg[(ql * TK + kk) * H + h] = e * gs;
      }
    }
    __syncthreads();

    // ds and eg out, rows (h, q) of contiguous keys
    for (int i = tid; i < TQ * H * TK; i += NT) {
      const int r = i / TK, kk = i % TK;
      const int hh = r / TQ, qq = r % TQ;
      const int qg = q0 + qq, kg = k0 + kk;
      if (qg < nQ && kg < kend) {
        const size_t o = (((size_t)b * H + hh) * nQ + qg) * nK + kg;
        ds_out[o] = s_ds[(qq * TK + kk) * H + hh];
        eg_out[o] = s_eg[(qq * TK + kk) * H + hh];
      }
    }
  }

  if (qvalid) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) atomicAdd(dq + qrow + g + TPR * i, dqa[i]);
  }
}

__global__ void __launch_bounds__(NT2)
rpe_table_bwd_kernel(
    const float* __restrict__ ds,       // (B, H, nQ, nK)
    const float* __restrict__ corners,  // (B, nQ, 8, 3)
    const float* __restrict__ cossin,   // (B, nQ, 2) or null
    const float* __restrict__ key_xyz,  // (B, nK, 3)
    const uint8_t* __restrict__ key_valid,  // (B, nK) or null
    float* __restrict__ dtables,        // (8, n, n, n, H), zeroed
    int nQ, int nK, int n, float log_scale, float max_value) {
  extern __shared__ float smem[];
  const int n3 = n * n * n;
  float* s_dt = smem;                     // n3 * H: this corner's dTable
  float* s_ds = s_dt + n3 * H;            // TQ2 * TK * H: ds, (pair, head)
  float* s_kxyz = s_ds + TQ2 * TK * H;    // TK * 3
  float* s_kmask = s_kxyz + TK * 3;       // TK: 1 valid, else 0
  float* s_corner = s_kmask + TK;         // TQ2 * 3: this corner's points
  float* s_cs = s_corner + TQ2 * 3;       // TQ2 * 2

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ2;
  const int c = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool rotate = cossin != nullptr;

  for (int i = tid; i < n3 * H; i += NT2) s_dt[i] = 0.f;
  for (int i = tid; i < TQ2 * 3; i += NT2) {
    const int qq = q0 + i / 3;
    s_corner[i] =
        qq < nQ ? corners[(((size_t)b * nQ + qq) * 8 + c) * 3 + i % 3] : 0.f;
  }
  for (int i = tid; i < TQ2 * 2; i += NT2) {
    const int qq = q0 + i / 2;
    s_cs[i] = (rotate && qq < nQ) ? cossin[((size_t)b * nQ + qq) * 2 + i % 2]
                                  : 0.f;
  }

  // each lane of the atomic phase owns one tap (dd, dh, dw) and one head
  const int tap_h = lane & (H - 1), tap = lane >> 2;
  const int tdd = tap >> 2, tdh = (tap >> 1) & 1, tdw = tap & 1;
  for (int k0 = 0; k0 < nK; k0 += TK) {
    __syncthreads();  // previous tile fully consumed (and smem init done)
    for (int i = tid; i < TK; i += NT2) {
      const int kk = k0 + i;
      s_kmask[i] = (kk < nK && (key_valid == nullptr ||
                                key_valid[(size_t)b * nK + kk])) ? 1.f : 0.f;
      for (int j = 0; j < 3; ++j)
        s_kxyz[i * 3 + j] =
            kk < nK ? key_xyz[((size_t)b * nK + kk) * 3 + j] : 0.f;
    }
    for (int i = tid; i < TQ2 * H * TK; i += NT2) {
      const int r = i / TK, kk = i % TK;
      const int hh = r / TQ2, qq = r % TQ2;
      const int qg = q0 + qq, kg = k0 + kk;
      s_ds[(qq * TK + kk) * H + hh] =
          (qg < nQ && kg < nK)
              ? ds[(((size_t)b * H + hh) * nQ + qg) * nK + kg] : 0.f;
    }
    __syncthreads();

    for (int base = warp * 32; base < TQ2 * TK; base += NT2) {
      const int p = base + lane;
      const int pq = p / TK, pk = p % TK;
      bool active = s_kmask[pk] > 0.f;
      if (active) {
        const float4 d4 = reinterpret_cast<const float4*>(s_ds)[p];
        active = d4.x != 0.f || d4.y != 0.f || d4.z != 0.f || d4.w != 0.f;
      }
      int packed = 0;
      float fw = 0.f, fh = 0.f, fd = 0.f;
      if (active) {
        float dx = s_corner[pq * 3 + 0] - s_kxyz[pk * 3 + 0];
        float dy = s_corner[pq * 3 + 1] - s_kxyz[pk * 3 + 1];
        const float dz = s_corner[pq * 3 + 2] - s_kxyz[pk * 3 + 2];
        if (rotate) {
          const float co = s_cs[pq * 2 + 0], si = s_cs[pq * 2 + 1];
          const float rx = dx * co - dy * si;
          const float ry = dx * si + dy * co;
          dx = rx;
          dy = ry;
        }
        const float iw = rpe::quantize(dx, log_scale, max_value, n);
        const float ih = rpe::quantize(dy, log_scale, max_value, n);
        const float id = rpe::quantize(dz, log_scale, max_value, n);
        const float w0 = floorf(iw), h0 = floorf(ih), d0 = floorf(id);
        fw = iw - w0;
        fh = ih - h0;
        fd = id - d0;
        // a lower tap below -1 or at n puts both taps of an axis outside
        const int cw0 = (int)w0, ch0 = (int)h0, cd0 = (int)d0;
        active = cw0 >= -1 && cw0 < n && ch0 >= -1 && ch0 < n &&
                 cd0 >= -1 && cd0 < n;
        packed = (cw0 + 1) | (ch0 + 1) << 5 | (cd0 + 1) << 10 | p << 15;
      }
      unsigned todo = __ballot_sync(0xffffffffu, active);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int pk_ = __shfl_sync(0xffffffffu, packed, src);
        const float ww = __shfl_sync(0xffffffffu, fw, src);
        const float wh = __shfl_sync(0xffffffffu, fh, src);
        const float wd = __shfl_sync(0xffffffffu, fd, src);
        const int cw = (pk_ & 31) - 1 + tdw;
        const int ch = ((pk_ >> 5) & 31) - 1 + tdh;
        const int cd = ((pk_ >> 10) & 31) - 1 + tdd;
        if (cw >= 0 && cw < n && ch >= 0 && ch < n && cd >= 0 && cd < n) {
          const float wt = (tdd ? wd : 1.f - wd) * (tdh ? wh : 1.f - wh) *
                           (tdw ? ww : 1.f - ww);
          atomicAdd(s_dt + ((cd * n + ch) * n + cw) * H + tap_h,
                    wt * s_ds[(pk_ >> 15) * H + tap_h]);
        }
      }
    }
  }
  __syncthreads();
  float* dst = dtables + (size_t)c * n3 * H;
  for (int i = tid; i < n3 * H; i += NT2) {
    const float val = s_dt[i];
    if (val != 0.f) atomicAdd(dst + i, val);
  }
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD>
int launch(const float* k, const float* v, const float* corners,
           const float* cossin, const float* key_xyz,
           const uint8_t* key_valid, const float* out, const float* dout,
           const float* logits, const float* lse, float* dq, float* dtables,
           float* ds, float* eg, Dropout drop, int B, int nQ, int nK, int n,
           float log_scale, float max_value, cudaStream_t stream) {
  // pair kernel: split the keys until ~3 blocks per SM have work
  const size_t smem1 =
      (2 * TK * HD + 3 * TQ * TK * H + TK) * sizeof(float);
  int err = set_smem((const void*)rpe_pair_bwd_kernel<HD>, smem1);
  if (err != 0) return err;
  const int qtiles = (nQ + TQ - 1) / TQ;
  const int ktiles = (nK + TK - 1) / TK;
  const int splits =
      max(1, min(ktiles, (3 * 132 + B * qtiles - 1) / (B * qtiles)));
  const int keys_per_block = ((ktiles + splits - 1) / splits) * TK;
  dim3 grid1(qtiles, B, (nK + keys_per_block - 1) / keys_per_block);
  rpe_pair_bwd_kernel<HD><<<grid1, NT, smem1, stream>>>(
      k, v, key_valid, out, dout, logits, lse, dq, ds, eg, drop, nQ, nK,
      keys_per_block);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  // table kernel: one block per (32 queries, batch row, corner)
  const size_t smem2 = ((size_t)n * n * n * H + TQ2 * TK * H + TK * 4 +
                        TQ2 * 5) * sizeof(float);
  err = set_smem((const void*)rpe_table_bwd_kernel, smem2);
  if (err != 0) return err;
  dim3 grid2((nQ + TQ2 - 1) / TQ2, B, 8);
  rpe_table_bwd_kernel<<<grid2, NT2, smem2, stream>>>(
      ds, corners, cossin, key_xyz, key_valid, dtables, nQ, nK, n,
      log_scale, max_value);
  return (int)cudaGetLastError();
}

}  // namespace

// dq and dtables must be zero on entry (the kernels add into them). A
// null seed means no dropout. Returns cudaErrorInvalidValue (1) for a
// head count, head width or table size the kernels are not built for.
extern "C" int rpe_cross_attention_bwd_f32(
    const void* k, const void* v, const void* corners, const void* cossin,
    const void* key_xyz, const void* key_valid, const void* out,
    const void* dout, const void* logits, const void* lse, const void* seed,
    void* dq, void* dtables, void* ds, void* eg, int B, int nQ, int nK,
    int heads, int hd, int n, float log_scale, float max_value, int rotate,
    int keep_threshold, float drop_scale, void* stream) {
  // the item packing holds table indices up to 31
  if (heads != H || n > 31) return (int)cudaErrorInvalidValue;
  if (B <= 0 || nQ <= 0 || nK <= 0) return (int)cudaGetLastError();
  const float* cs = rotate ? (const float*)cossin : nullptr;
  const Dropout drop{(const long long*)seed, (uint32_t)keep_threshold,
                     drop_scale};
  auto args = [&](auto fn) {
    return fn((const float*)k, (const float*)v, (const float*)corners, cs,
              (const float*)key_xyz, (const uint8_t*)key_valid,
              (const float*)out, (const float*)dout, (const float*)logits,
              (const float*)lse, (float*)dq, (float*)dtables, (float*)ds,
              (float*)eg, drop, B, nQ, nK, n, log_scale, max_value,
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
