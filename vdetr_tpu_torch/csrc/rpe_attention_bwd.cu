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
// - the table kernel scatters dTables from ds as a privatized weighted
//   histogram: one block per (batch, 32 queries, corner pair (i, i + 4),
//   share of the keys), the keys split until ~4 blocks per SM are
//   resident, keeps both corners' tables (32 KB at n = 10, H = 4) in
//   shared memory and adds their nonzero entries to the global dTables
//   with one atomic add each at the end. A warp takes one query and 32
//   keys at a time: each lane quantizes its (pair, corner) deltas, x and
//   y once for the pair when the two corners' x and y agree bit for bit
//   (a box's corners i and i + 4 differ in z alone), and stages its
//   item's ds and 8 tap weights per corner in the warp's shared buffer,
//   with its lower tap cell and in-table tap mask in a register. Then for
//   each item the 32 lanes (8 taps x 4 heads, 32 distinct words in 32
//   distinct banks) add their weighted ds with one shared atomic each.
//   On this card a shared f32 atomicAdd compiles to a compare-and-swap
//   loop (ATOMS.CAST.SPIN in the SASS), not a native add. Grouping the
//   warp's items by cell with __match_any_sync first, one atomic per
//   cell, was slower (PERF.md §6): the warp's 32 keys, in FPS
//   order, spread over most of the cells (chip_smoke prints the mean),
//   so the per-group work cost more than the atomics it saved. The kernel it replaced (one block per corner,
//   fewer than 2 per SM, the warp walking its items one by one through
//   four shuffles and an atomic each) ran 3.75 ms a layer.

#include "rpe_common.cuh"

namespace {

constexpr int H = 4;              // heads (the published model's 4)
constexpr int TQ = 8;             // queries per pair block
constexpr int TK = 64;            // keys per tile
constexpr int TPR = 4;            // threads per (query, head) row
constexpr int NT = TQ * H * TPR;  // 128 threads
constexpr int TQ2 = 32;           // queries per table block
constexpr int NT2 = 256;          // threads per table block
constexpr int NW2 = NT2 / 32;     // its warps

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

// Per pair item: ds of the 4 heads, then for each corner of the pair the
// 8 trilinear tap weights; a warp's 32 items (one query, 32 keys).
constexpr int ITEM_FLOATS = 32 * (H + 2 * 8);

// One corner of a pair item: its 8 tap weights to `wts`, and its key: the
// table offset of its lower tap cell, (cd0 * n + ch0) * n + cw0 shifted
// by n^2 + n + 1 to be >= 0, times 256, plus the mask of the taps that lie
// in the table (bit dd * 4 + dh * 2 + dw); -1 when none does or the item
// is inactive.
__device__ __forceinline__ int corner_item(bool active, float iw, float ih,
                                           float id, int n,
                                           float* __restrict__ wts) {
  const float w0 = floorf(iw), h0 = floorf(ih), d0 = floorf(id);
  const float fw = iw - w0, fh = ih - h0, fd = id - d0;
  const int cw0 = (int)w0, ch0 = (int)h0, cd0 = (int)d0;
  // an axis's lower tap is in the table from 0, its upper one below n
  const int tw = (cw0 >= 0 && cw0 < n ? 0x55 : 0) |
                 (cw0 >= -1 && cw0 < n - 1 ? 0xAA : 0);
  const int th = (ch0 >= 0 && ch0 < n ? 0x33 : 0) |
                 (ch0 >= -1 && ch0 < n - 1 ? 0xCC : 0);
  const int td = (cd0 >= 0 && cd0 < n ? 0x0F : 0) |
                 (cd0 >= -1 && cd0 < n - 1 ? 0xF0 : 0);
  const int taps = active ? tw & th & td : 0;
  float w[8];
#pragma unroll
  for (int tap = 0; tap < 8; ++tap) {
    const int tdd = tap >> 2, tdh = (tap >> 1) & 1, tdw = tap & 1;
    w[tap] = (tdd ? fd : 1.f - fd) * (tdh ? fh : 1.f - fh) *
             (tdw ? fw : 1.f - fw);
  }
  reinterpret_cast<float4*>(wts)[0] = make_float4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<float4*>(wts)[1] = make_float4(w[4], w[5], w[6], w[7]);
  return taps ? ((cd0 * n + ch0) * n + cw0 + n * n + n + 1) << 8 | taps
              : -1;
}

__global__ void __launch_bounds__(NT2, 4)
rpe_table_bwd_kernel(
    const float* __restrict__ ds,       // (B, H, nQ, nK)
    const float* __restrict__ corners,  // (B, nQ, 8, 3)
    const float* __restrict__ cossin,   // (B, nQ, 2) or null
    const float* __restrict__ key_xyz,  // (B, nK, 3)
    const uint8_t* __restrict__ key_valid,  // (B, nK) or null
    float* __restrict__ dtables,        // (8, n, n, n, H), zeroed
    int nQ, int nK, int n, float log_scale, float max_value,
    int keys_per_block) {
  extern __shared__ float smem[];
  const int n3 = n * n * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* s_dt = smem;                          // 2 * n3 * H: both tables
  float* s_item = s_dt + 2 * n3 * H;           // NW2 * ITEM_FLOATS
  float* s_corner = s_item + NW2 * ITEM_FLOATS;  // TQ2 * 2 * 3
  float* s_cs = s_corner + TQ2 * 6;            // TQ2 * 2
  int* s_pairxy = reinterpret_cast<int*>(s_cs + TQ2 * 2);  // TQ2
  float* s_ds = s_item + warp * ITEM_FLOATS;   // this warp's items: 32 x H
  float* s_w = s_ds + 32 * H;                  // 2 x 32 x 8

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ2;
  const int cp = blockIdx.z % 4;  // corners cp and cp + 4
  const int kbeg = (blockIdx.z / 4) * keys_per_block;
  const int kend = min(nK, kbeg + keys_per_block);
  const bool rotate = cossin != nullptr;

  for (int i = tid; i < 2 * n3 * H; i += NT2) s_dt[i] = 0.f;
  for (int i = tid; i < TQ2 * 6; i += NT2) {
    const int qq = q0 + i / 6, j = (i / 3) % 2;
    s_corner[i] = qq < nQ ? corners[(((size_t)b * nQ + qq) * 8 + cp + 4 * j)
                                    * 3 + i % 3]
                          : 0.f;
  }
  for (int i = tid; i < TQ2 * 2; i += NT2) {
    const int qq = q0 + i / 2;
    s_cs[i] = (rotate && qq < nQ) ? cossin[((size_t)b * nQ + qq) * 2 + i % 2]
                                  : 0.f;
  }
  __syncthreads();
  // corners i and i + 4 of a box differ in z alone: then the x and y
  // quantizes of a pair item are done once (exact, as the bits agree)
  for (int i = tid; i < TQ2; i += NT2) {
    const float* c = s_corner + i * 6;
    s_pairxy[i] = rpe::same_bits(c[0], c[3]) && rpe::same_bits(c[1], c[4]);
  }
  __syncthreads();

  // each lane of the scatter owns one tap (dd, dh, dw) and one head
  const int tap_h = lane & (H - 1), tap = lane >> 2;
  const int tap_off = ((tap >> 2) * n + ((tap >> 1) & 1)) * n + (tap & 1);
  const int base0 = n * n + n + 1;  // corner_item's shift of the cell
  const int kchunks = (kend - kbeg + 31) / 32;
  // task = (key chunk, query): the block's warps share a key chunk
  for (int task = warp; task < kchunks * TQ2; task += NW2) {
    const int ql = task % TQ2;
    const int qi = q0 + ql;
    const int kk = kbeg + (task / TQ2) * 32 + lane;
    bool active = qi < nQ && kk < kend &&
                  (key_valid == nullptr || key_valid[(size_t)b * nK + kk]);
    float4 d4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) {
      const float* dsp = ds + ((size_t)b * H * nQ + qi) * nK + kk;
      const size_t hs = (size_t)nQ * nK;
      d4 = make_float4(dsp[0], dsp[hs], dsp[2 * hs], dsp[3 * hs]);
      active = d4.x != 0.f || d4.y != 0.f || d4.z != 0.f || d4.w != 0.f;
    }
    reinterpret_cast<float4*>(s_ds)[lane] = d4;
    float iw[2] = {0.f, 0.f}, ih[2] = {0.f, 0.f}, id[2] = {0.f, 0.f};
    if (active) {
      const float* kx = key_xyz + ((size_t)b * nK + kk) * 3;
      const float kx0 = kx[0], kx1 = kx[1], kx2 = kx[2];
      const float* c = s_corner + ql * 6;
      const float co = s_cs[ql * 2 + 0], si = s_cs[ql * 2 + 1];
      // the x and y indices of corner j's delta, rotated into the box frame
      auto quantize_xy = [&](int j, float& qx, float& qy) {
        float dx = c[3 * j + 0] - kx0;
        float dy = c[3 * j + 1] - kx1;
        if (rotate) {
          const float rx = dx * co - dy * si;
          const float ry = dx * si + dy * co;
          dx = rx;
          dy = ry;
        }
        qx = rpe::quantize(dx, log_scale, max_value, n);
        qy = rpe::quantize(dy, log_scale, max_value, n);
      };
      quantize_xy(0, iw[0], ih[0]);
      if (s_pairxy[ql]) {
        iw[1] = iw[0];
        ih[1] = ih[0];
      } else {
        quantize_xy(1, iw[1], ih[1]);
      }
      id[0] = rpe::quantize(c[2] - kx2, log_scale, max_value, n);
      id[1] = rpe::quantize(c[5] - kx2, log_scale, max_value, n);
    }
    int cell[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      cell[j] = corner_item(active, iw[j], ih[j], id[j], n,
                            s_w + (j * 32 + lane) * 8);
    __syncwarp();

    // per corner, item by item: each (tap, head) lane adds its weighted
    // ds to its own table word, 32 distinct words in 32 distinct banks
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* wj = s_w + j * 32 * 8 + tap;
      float* dt = s_dt + (j * n3 + tap_off) * H + tap_h;
#pragma unroll 4
      for (int m = 0; m < 32; ++m) {
        const int key = __shfl_sync(0xffffffffu, cell[j], m);
        if (key >= 0 && ((key >> tap) & 1))
          atomicAdd(dt + ((key >> 8) - base0) * H,
                    wj[m * 8] * s_ds[m * H + tap_h]);
      }
    }
    __syncwarp();  // the items are read before the next task's land
  }
  __syncthreads();
  for (int i = tid; i < 2 * n3 * H; i += NT2) {
    const float val = s_dt[i];
    const int j = i / (n3 * H);
    if (val != 0.f)
      atomicAdd(dtables + (size_t)(cp + 4 * j) * n3 * H + i - j * n3 * H,
                val);
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
  // table kernel: one block per (32 queries, batch row, corner pair,
  // share of the keys), the keys split until ~4 blocks per SM have work
  const size_t smem2 = (2 * (size_t)n * n * n * H + NW2 * ITEM_FLOATS +
                        TQ2 * 9) * sizeof(float);
  err = set_smem((const void*)rpe_table_bwd_kernel, smem2);
  if (err != 0) return err;
  const int qtiles2 = (nQ + TQ2 - 1) / TQ2;
  const int kchunks = (nK + 31) / 32;
  const int shares2 =
      max(1, min(kchunks, (4 * 132) / (B * qtiles2 * 4)));
  const int keys_per_block2 = ((kchunks + shares2 - 1) / shares2) * 32;
  dim3 grid2(qtiles2, B,
             4 * ((nK + keys_per_block2 - 1) / keys_per_block2));
  rpe_table_bwd_kernel<<<grid2, NT2, smem2, stream>>>(
      ds, corners, cossin, key_xyz, key_valid, dtables, nQ, nK, n,
      log_scale, max_value, keys_per_block2);
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
