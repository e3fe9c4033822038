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
// Two kernels run back to back (a third adds dQ's key shares, and
// rpe_table_sum.cu the table kernel's slices):
// - the pair kernel forms dp, ds, eg and dQ as the two GEMMs of a
//   FlashAttention-2 backward, dp = dO . V^T and dQ += ds . K, on the
//   tensor cores in split TF32 (tensor_core.cuh: three m16n8k8 MMAs per
//   f32 product, each stage chained from 0 and added in f32; one TF32
//   pass misses the test tolerance, tests/test_torch_kernel_premises.py).
//   A block owns 16 queries x 4 heads and one share of the keys; warp h
//   owns head h's 16 queries, one m16 slab, whose dO fragments it splits
//   once and keeps in registers. It walks its keys in 32-key tiles: K,
//   V and the block's 64 logits rows, double-buffered in shared memory
//   by cp.async (K and V rows padded to HD + 4 floats, logits rows to 40,
//   so that every fragment and logits read is free of bank conflicts).
//   V feeds dp's B fragments as stored (row-major by key is .col for
//   V^T). e, the dropout keep and ds are formed in registers on dp's
//   accumulator fragment: a thread holds keys 2t and 2t + 1 of rows g and
//   g + 8, hashes exactly those pairs, and writes their ds and eg as
//   8-byte pieces (whole 32-byte sectors per warp); the key mask is one
//   ballot a tile. The same registers are dQ's A fragment when the k8
//   step's column t stands for key 2t and column t + 4 for key 2t + 1,
//   so dQ's B fragment reads K's rows 2t and 2t + 1: ds never leaves the
//   registers on its way to dQ. Each key share writes its dQ to its own
//   slice of a scratch buffer and rpe_dq_sum_kernel adds the shares in
//   share order: no atomics, and dQ repeats bit for bit. The wrapper
//   picks the key split (ops/rpe_attention.py:pair_key_split: the fewest
//   waves x tiles a block over the card's SMs at 3 blocks an SM, the
//   launch bounds for 3 blocks of 128 threads at head widths up to 64)
//   and sizes the scratch to it. Its bound is the bytes (the logits in,
//   ds and eg out); what holds it is instruction issue: the TF32 splits
//   of every K and V value in each of the 4 warps (integer rounding,
//   tc::split_tf32), the hash and the exp of every pair, with 12 warps an
//   SM to hide the MMA and shared-memory latencies.
// - the table kernel scatters dTables from ds as a privatized weighted
//   histogram: one block per (batch, 32 queries, corner pair (i, i + 4),
//   share of the keys), the keys split until TABLE_BLOCKS_PER_SM blocks
//   per SM have work (ops/rpe_attention.py:table_key_split). A warp takes
//   one query and 32 keys at a time: each lane quantizes its (pair,
//   corner) deltas, x and y once for the pair when the two corners' x and
//   y agree bit for bit (a box's corners i and i + 4 differ in z alone),
//   and stages its item's ds and 8 tap weights per corner in the warp's
//   shared buffer, with its lower tap cell and in-table tap mask in a
//   register. Then for each item the 32 lanes (8 taps x 4 heads, 32
//   distinct words in 32 distinct banks) add their weighted ds to the
//   block's two tables in shared memory. The tables hold 64-bit
//   fixed-point integers: w * ds times 2^k (2^k folded into the staged
//   weights), rounded to an integer below 2^30 in magnitude (k from the
//   launch's largest |ds|, which the pair blocks record), added by one
//   native 32-bit shared atomic on the low half and, on a carry out of
//   it, one on the high half (add_fixed). Integer adds commute, so the 16 warps' order of arrival
//   changes no bit; a shared f32 atomicAdd would be a compare-and-swap
//   loop (ATOMS.CAST.SPIN) in an order that varies from run to run. Two
//   atomics for every term, each half's sum kept below 2^31 by splitting
//   the term at 2^15, ran 1.89 ms a launch against this form's (PERF.md
//   §6): nearly every term has a high part. Each block
//   then writes its tables whole, zeros included, as floats to its own
//   slice, and rpe_table_sum.cu adds the slices in slice order: dTables
//   repeats bit for bit, with no global atomics. Rounding each term to
//   a multiple of 2^-k costs at most 2^-30 of the largest |ds| a term
//   (tests/test_torch_kernel_premises.py holds the sums to the plain
//   index_add_ within F's tolerance at the published shape). Grouping the
//   warp's items by cell with __match_any_sync first, one atomic per
//   cell, was slower (PERF.md §6): the warp's 32 keys, in FPS order,
//   spread over most of the cells (chip_smoke prints the mean). The
//   kernel it replaced (one block per corner, fewer than 2 per SM, the
//   warp walking its items one by one through four shuffles and an
//   atomic each) ran 3.75 ms a layer.

#include "rpe_common.cuh"
#include "tensor_core.cuh"

namespace {

using tc::aligned16;
using tc::cp_async16;
using tc::cp_async4;
using tc::cp_commit;
using tc::cp_wait;
using tc::mma_tf32;
using tc::split_tf32;

constexpr int H = 4;              // heads (the published model's 4)
constexpr int PQ = 16;            // queries per pair block: one m16 slab
constexpr int PK = 32;            // keys per pair tile: one a lane
static_assert(PK == 32, "the pair kernel's key masks take one key a lane");
constexpr int NT = 32 * H;        // 128 threads: warp h takes head h
constexpr int SMS = 132;          // the H100 SXM's SMs
constexpr int TQ2 = 32;           // queries per table block
constexpr int NT2 = 512;          // threads per table block
constexpr int NW2 = NT2 / 32;     // its warps
// table blocks resident per SM: each holds its two tables as 64-bit
// integer words (64 KB at n = 10, H = 4) and its 16 warps' items (40 KB)
// (ops/rpe_attention.py:table_key_split counts the same)
constexpr int TABLE_BLOCKS_PER_SM = 2;

// pair blocks resident per SM: registers for 3 at a head width of 64
// (ops/rpe_attention.py:pair_key_split counts the same)
constexpr int pair_blocks_per_sm(int hd) { return hd <= 64 ? 3 : 1; }

struct Dropout {
  const long long* seed;  // device scalar; null: no dropout
  uint32_t threshold;
  float scale;
  uint32_t key_offset;  // global index of key 0, as the forward's
};

// this thread's two adjacent keys of one row of ds or eg: 8 bytes when
// `vec` (even row length, 8-byte aligned base), else one by one; none
// past `n`
__device__ __forceinline__ void store_pair(float* p, float2 x, int n,
                                           bool vec) {
  if (vec && n >= 2) {
    __stcs(reinterpret_cast<float2*>(p), x);
    return;
  }
  if (n >= 1) __stcs(p, x.x);
  if (n >= 2) __stcs(p + 1, x.y);
}

template <int HD>
__global__ void __launch_bounds__(NT, pair_blocks_per_sm(HD))
rpe_pair_bwd_kernel(
    const float* __restrict__ k,        // (B, nK, HD)
    const float* __restrict__ v,        // (B, nK, HD)
    const uint8_t* __restrict__ key_valid,  // (B, nK) or null
    const float* __restrict__ out,      // (B, nQ, H, HD)
    const float* __restrict__ dout,     // (B, nQ, H, HD)
    const float* __restrict__ logits,   // (B, H, nQ, nK)
    const float* __restrict__ lse,      // (B, nQ, H)
    float* __restrict__ dq,             // (shares, B, nQ, H, HD): share z's
                                        // dQ at z * share_elems
    float* __restrict__ ds_out,         // (B, H, nQ, nK)
    float* __restrict__ eg_out,         // (B, H, nQ, nK)
    float* __restrict__ ds_absmax,      // one per block: max |ds|
    Dropout drop, int nQ, int nK, int keys_per_block, size_t share_elems,
    bool vec, bool kv16, bool l16) {
  constexpr int KS = HD + 4;       // K, V row stride in shared memory
  constexpr int LS = PK + 8;       // logits row stride in shared memory
  constexpr int NKS = HD / 8;      // k8 steps of dp, n8 tiles of dQ
  constexpr int NJ = PK / 8;       // n8 tiles of dp, k8 steps of dQ
  constexpr int NG = NKS < 8 ? NKS : 8;  // dQ tiles per partial sum
  constexpr int SLOT = 2 * PK * KS + H * PQ * LS;  // K, V, logits tiles
  extern __shared__ __align__(16) float smem[];  // 2 slots

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * PQ;
  const int kbeg = blockIdx.z * keys_per_block;
  const int kend = min(nK, kbeg + keys_per_block);
  const int tid = threadIdx.x;
  const int lane = tid & 31, h = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool dropout = drop.seed != nullptr;

  int any_valid = key_valid == nullptr;
  if (!any_valid) {
    for (int i = tid; i < nK; i += NT)
      any_valid |= key_valid[(size_t)b * nK + i] != 0;
  }
  any_valid = __syncthreads_or(any_valid);
  const float uniform = any_valid ? 0.f : 1.f / nK;

  // the thread's rows g and g + 8 of the slab: dO's A fragments split
  // once (a[r + 2c] is row g + 8r, column t + 4c), D = dO . O, lse, and
  // the dropout row hash
  uint32_t doh[NKS][4], dol[NKS][4];
  float D[2], lse_r[2];
  uint32_t rowh[2];
  bool rv[2];
  size_t orow[2];  // the rows' offsets in logits, ds and eg
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + g + 8 * r;
    rv[r] = qi < nQ;
    const size_t base = (((size_t)b * nQ + (rv[r] ? qi : 0)) * H + h) * HD;
    float d = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int dim = 8 * ks + t + 4 * c;
        const float x = rv[r] ? dout[base + dim] : 0.f;
        d += x * (rv[r] ? out[base + dim] : 0.f);
        split_tf32(x, doh[ks][r + 2 * c], dol[ks][r + 2 * c]);
      }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    D[r] = d;
    lse_r[r] = rv[r] ? lse[((size_t)b * nQ + qi) * H + h] : 0.f;
    rowh[r] = dropout ? rpe::row_hash((uint32_t)*drop.seed,
                                      (uint32_t)((b * H + h) * nQ + qi))
                      : 0u;
    orow[r] = (((size_t)b * H + h) * nQ + qi) * nK;
  }

  float amax = 0.f;   // max |ds| of the thread's pairs
  float acc[NKS][4];  // dQ: rows g, g + 8; columns 8 n + 2t, + 1
#pragma unroll
  for (int n = 0; n < NKS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // issue the copies of tile `it` into ring slot `slot`: K and V rows,
  // and the block's logits rows (h, q0 + i) of the tile's keys
  auto load = [&](int it, int slot) {
    const int k0 = kbeg + it * PK;
    float* sk = smem + slot * SLOT;
    float* sv = sk + PK * KS;
    float* sl = sv + PK * KS;
    const size_t row0 = (size_t)b * nK + k0;
    const size_t lrow0 = ((size_t)b * H * nQ + q0) * nK + k0;
    if (kv16) {
      for (int i = tid; i < PK * HD / 4; i += NT) {
        const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
        const bool p = k0 + r < kend;
        const size_t o = (row0 + r) * HD + c;
        cp_async16(sk + r * KS + c, p ? k + o : k, p);
        cp_async16(sv + r * KS + c, p ? v + o : v, p);
      }
    } else {
      for (int i = tid; i < PK * HD; i += NT) {
        const int r = i / HD, c = i % HD;
        const bool p = k0 + r < kend;
        const size_t o = (row0 + r) * HD + c;
        cp_async4(sk + r * KS + c, p ? k + o : k, p);
        cp_async4(sv + r * KS + c, p ? v + o : v, p);
      }
    }
    constexpr int W = 4;  // floats a 16-byte copy
    for (int i = tid; i < H * PQ * PK / (l16 ? W : 1); i += NT) {
      const int row = l16 ? i / (PK / W) : i / PK;
      const int c = l16 ? (i % (PK / W)) * W : i % PK;
      const int hh = row / PQ, qq = row % PQ;
      // a 16-byte copy lies inside [0, kend) or outside it: kend and k0
      // are multiples of 4 when l16
      const bool p = q0 + qq < nQ && k0 + c < kend;
      const float* src = logits + lrow0 + ((size_t)hh * nQ + qq) * nK + c;
      if (l16)
        cp_async16(sl + row * LS + c, p ? src : logits, p);
      else
        cp_async4(sl + row * LS + c, p ? src : logits, p);
    }
  };

  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  const int ntiles = (kend - kbeg + PK - 1) / PK;
  load(0, 0);
  cp_commit();
  for (int it = 0; it < ntiles; ++it) {
    cp_wait<0>();
    __syncthreads();  // tile `it` landed; tile it - 1's slot is free
    if (it + 1 < ntiles) load(it + 1, (it + 1) & 1);
    cp_commit();
    const float* sk = smem + (it & 1) * SLOT;
    const float* sv = sk + PK * KS;
    const float* sl = sv + PK * KS + (h * PQ + g) * LS + 2 * t;
    const int k0 = kbeg + it * PK;

    // the tile's key masks, bit i for key k0 + i: inside the share, and
    // valid (one key a lane), shifted so that bit 8j + c is the thread's
    // key k0 + 8j + 2t + c
    const int kin = kend - k0;
    uint32_t inside = kin >= PK ? 0xffffffffu : (1u << kin) - 1u;
    uint32_t valid = inside;
    if (key_valid != nullptr)
      valid = __ballot_sync(
          0xffffffffu,
          lane < kin && key_valid[(size_t)b * nK + min(k0 + lane, nK - 1)]);
    inside >>= 2 * t;
    valid >>= 2 * t;

    // dp = dO . V^T over the tile's keys: B fragment (k = dim, n = key)
    // is V[key][dim] as stored
    float dp[NJ][4];
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* v0 = sv + (8 * j + g) * KS + 8 * ks + t;
        uint32_t bh[2], bl[2];
        split_tf32(v0[0], bh[0], bl[0]);
        split_tf32(v0[4], bh[1], bl[1]);
        if (ks == 0)
          mma_tf32(dp[j], dol[ks], bh, zero);
        else
          mma_tf32(dp[j], dol[ks], bh, dp[j]);
        mma_tf32(dp[j], doh[ks], bl, dp[j]);
        mma_tf32(dp[j], doh[ks], bh, dp[j]);
      }

    // e, the dropout keep, ds and eg on the accumulator fragment; ds
    // replaces dp in place. The logits rows' stride LS puts the warp's
    // 8-byte reads in distinct banks.
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int key = k0 + 8 * j + 2 * t;
      const int left = kend - key;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(sl + 8 * r * LS + 8 * j);
        const float l[2] = {l2.x, l2.y};
        float egv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int bit = 8 * j + c;
          const bool kv = (valid >> bit) & 1;  // implies inside
          const float ex = expf(l[c] - lse_r[r]);
          const float e = (rv[r] && ((inside >> bit) & 1))
                              ? (kv ? ex : uniform) : 0.f;
          const float gs =
              dropout ? (rpe::keep(rowh[r],
                                   (uint32_t)(key + c) + drop.key_offset,
                                   drop.threshold) ? drop.scale : 0.f)
                      : 1.f;
          const float dsv =
              (rv[r] && kv) ? e * (gs * dp[j][2 * r + c] - D[r]) : 0.f;
          dp[j][2 * r + c] = dsv;
          amax = fmaxf(amax, fabsf(dsv));
          egv[c] = e * gs;
        }
        if (rv[r]) {
          const size_t o = orow[r] + key;
          store_pair(ds_out + o, make_float2(dp[j][2 * r], dp[j][2 * r + 1]),
                     left, vec);
          store_pair(eg_out + o, make_float2(egv[0], egv[1]), left, vec);
        }
      }
    }

    // dQ += ds . K over the tile's keys. The accumulator fragment of dp
    // tile j is the A fragment of k8 step j when column t stands for key
    // 2t and column t + 4 for key 2t + 1; the B fragment (k = key, n =
    // dim) then reads K's rows 2t and 2t + 1. Each partial sum starts at
    // 0 and is added to acc in f32.
#pragma unroll
    for (int n0 = 0; n0 < NKS; n0 += NG) {
      float part[NG][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t ah[4], al[4];
        split_tf32(dp[j][0], ah[0], al[0]);
        split_tf32(dp[j][2], ah[1], al[1]);
        split_tf32(dp[j][1], ah[2], al[2]);
        split_tf32(dp[j][3], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const float* k0p = sk + (8 * j + 2 * t) * KS + 8 * (n0 + n) + g;
          uint32_t bh[2], bl[2];
          split_tf32(k0p[0], bh[0], bl[0]);
          split_tf32(k0p[KS], bh[1], bl[1]);
          if (j == 0)
            mma_tf32(part[n], al, bh, zero);
          else
            mma_tf32(part[n], al, bh, part[n]);
          mma_tf32(part[n], ah, bl, part[n]);
          mma_tf32(part[n], ah, bh, part[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
    }
  }
  cp_wait<0>();  // no copy may outlive the block's shared memory

  // the block's max |ds| (the table kernel's fixed-point scale): an
  // order-free max over the bits of non-negative floats
  __shared__ uint32_t s_amax[H];
  const uint32_t wmax = __reduce_max_sync(0xffffffffu, __float_as_uint(amax));
  if (lane == 0) s_amax[h] = wmax;
  __syncthreads();
  if (tid == 0) {
    uint32_t m = s_amax[0];
    for (int i = 1; i < H; ++i) m = max(m, s_amax[i]);
    ds_absmax[((size_t)blockIdx.z * gridDim.y + b) * gridDim.x + blockIdx.x] =
        __uint_as_float(m);
  }

  float* dst = dq + blockIdx.z * share_elems;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!rv[r]) continue;
    float* o = dst + (((size_t)b * nQ + q0 + g + 8 * r) * H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NKS; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// dq = the key shares' dQ added in share order (rpe::slices_sum)
__global__ void __launch_bounds__(256)
rpe_dq_sum_kernel(const float* __restrict__ parts, float* __restrict__ dq,
                  size_t n, int shares, bool vec4) {
  rpe::slices_sum(parts, dq, n, shares, vec4);
}

// Per pair item: ds of the 4 heads, then for each corner of the pair the
// 8 trilinear tap weights; a warp's 32 items (one query, 32 keys).
constexpr int ITEM_FLOATS = 32 * (H + 2 * 8);

// One corner of a pair item: its 8 tap weights times `scale` (a power of
// 2, so the products are exact) to `wts`, and its key: the
// table offset of its lower tap cell, (cd0 * n + ch0) * n + cw0 shifted
// by n^2 + n + 1 to be >= 0, times 256, plus the mask of the taps that lie
// in the table (bit dd * 4 + dh * 2 + dw); -1 when none does or the item
// is inactive.
__device__ __forceinline__ int corner_item(bool active, float iw, float ih,
                                           float id, int n, float scale,
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
             (tdw ? fw : 1.f - fw) * scale;
  }
  reinterpret_cast<float4*>(wts)[0] = make_float4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<float4*>(wts)[1] = make_float4(w[4], w[5], w[6], w[7]);
  return taps ? ((cd0 * n + ch0) * n + cw0 + n * n + n + 1) << 8 | taps
              : -1;
}

// The fixed-point scale of the table sums, 2^k: every weighted ds w * ds
// (|w| <= 1) of the launch becomes s = w * ds * 2^k of magnitude < 2^30,
// from the largest |ds| M < 2^e (k = 30 - e, at most 126 so 2^k and 2^-k
// are normal floats). 0 when M is not finite (the tables are then NaN).
__device__ __forceinline__ int table_scale_exp(float m) {
  if (!isfinite(m)) return 0;
  int e;
  frexpf(m, &e);  // m = f 2^e, f in [0.5, 1); e = 0 for m = 0
  return min(30 - e, 126);
}

// A block's two tables are 64-bit integer sums, each word kept as a low
// and a high 32-bit half in two shared arrays. add_fixed adds x (|x| <
// 2^31) to word w: the low half by one native shared atomic add, whose
// old value gives the carry out (add.cc), then the high half, when the
// sign extension plus the carry is not 0 (for a small x, mostly not).
// Integer adds commute, so the block's final words are the same bits
// whatever order its warps add in.
__device__ __forceinline__ void add_fixed(uint32_t* lo, int* hi, int w,
                                          int x) {
  const uint32_t old = atomicAdd(lo + w, (uint32_t)x);
  int carry;
  asm("{\n\t.reg .u32 t;\n\tadd.cc.u32 t, %1, %2;\n\t"
      "addc.s32 %0, %3, 0;\n\t}"
      : "=r"(carry)
      : "r"(old), "r"((uint32_t)x), "r"(x >> 31));
  if (carry != 0) atomicAdd(hi + w, carry);
}

__global__ void __launch_bounds__(NT2, TABLE_BLOCKS_PER_SM)
rpe_table_bwd_kernel(
    const float* __restrict__ ds,       // (B, H, nQ, nK)
    const float* __restrict__ corners,  // (B, nQ, 8, 3)
    const float* __restrict__ cossin,   // (B, nQ, 2) or null
    const float* __restrict__ key_xyz,  // (B, nK, 3)
    const uint8_t* __restrict__ key_valid,  // (B, nK) or null
    const float* __restrict__ ds_absmax,  // (n_absmax,) pair blocks' max|ds|
    int n_absmax,
    float* __restrict__ slices,  // (B, qtiles, shares, 8, n, n, n, H)
    int nQ, int nK, int n, float log_scale, float max_value,
    int keys_per_block) {
  extern __shared__ float smem[];
  const int n3 = n * n * n;
  const int words = 2 * n3 * H;  // both tables
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  uint32_t* s_lo = reinterpret_cast<uint32_t*>(smem);  // words
  int* s_hi = reinterpret_cast<int*>(s_lo + words);    // words
  float* s_item = reinterpret_cast<float*>(s_hi + words);  // NW2 * ITEM
  float* s_corner = s_item + NW2 * ITEM_FLOATS;  // TQ2 * 2 * 3
  float* s_cs = s_corner + TQ2 * 6;            // TQ2 * 2
  int* s_pairxy = reinterpret_cast<int*>(s_cs + TQ2 * 2);  // TQ2
  float* s_ds = s_item + warp * ITEM_FLOATS;   // this warp's items: 32 x H
  float* s_w = s_ds + 32 * H;                  // 2 x 32 x 8
  __shared__ uint32_t s_max[NW2];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ2;
  const int cp = blockIdx.z % 4;  // corners cp and cp + 4
  const int share = blockIdx.z / 4;
  const int kbeg = share * keys_per_block;
  const int kend = min(nK, kbeg + keys_per_block);
  const bool rotate = cossin != nullptr;

  // the launch's max |ds| from the pair blocks' maxima: the scale 2^k
  uint32_t m = 0;
  for (int i = tid; i < n_absmax; i += NT2)
    m = max(m, __float_as_uint(ds_absmax[i]));
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) s_max[warp] = m;
  for (int i = tid; i < 2 * words; i += NT2) s_lo[i] = 0u;  // and s_hi
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
  for (int w = 0; w < NW2; ++w) m = max(m, s_max[w]);
  const float amax = __uint_as_float(m);
  const int k = table_scale_exp(amax);
  const float scale = __int_as_float((127 + k) << 23);  // 2^k
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
      cell[j] = corner_item(active, iw[j], ih[j], id[j], n, scale,
                            s_w + (j * 32 + lane) * 8);
    __syncwarp();

    // per corner, item by item: each (tap, head) lane adds its weighted
    // ds, in fixed point, to its own table word, 32 distinct words in 32
    // distinct banks
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* wj = s_w + j * 32 * 8 + tap;
      const int w0 = (j * n3 + tap_off) * H + tap_h;
#pragma unroll 4
      for (int mm = 0; mm < 32; ++mm) {
        const int key = __shfl_sync(0xffffffffu, cell[j], mm);
        if (key >= 0 && ((key >> tap) & 1))
          add_fixed(s_lo, s_hi, w0 + ((key >> 8) - base0) * H,
                    __float2int_rn(wj[mm * 8] * s_ds[mm * H + tap_h]));
      }
    }
    __syncwarp();  // the items are read before the next task's land
  }
  __syncthreads();
  // the block's slice: both tables whole, zeros included, as floats
  const float inv = __int_as_float((127 - k) << 23);  // 2^-k
  const bool finite = isfinite(amax);
  float* dst = slices +
               (((size_t)b * gridDim.x + blockIdx.x) * (gridDim.z / 4) +
                share) * 8 * n3 * H;
  for (int i = tid; i < words; i += NT2) {
    const int j = i / (n3 * H);
    const long long v = (long long)(((unsigned long long)(uint32_t)s_hi[i]
                                     << 32) | s_lo[i]);
    dst[(size_t)(cp + 4 * j) * n3 * H + i - j * n3 * H] =
        finite ? __ll2float_rn(v) * inv : __int_as_float(0x7fc00000);
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
           const float* logits, const float* lse, float* dq, float* dq_parts,
           float* ds_absmax, float* slices, float* ds, float* eg,
           Dropout drop, int B, int nQ, int nK, int n, float log_scale,
           float max_value, int keys_per_block, int table_keys_per_block,
           cudaStream_t stream) {
  // pair kernel: two slots of K, V and logits tiles in shared memory
  const size_t smem1 =
      2 * (2 * PK * (HD + 4) + H * PQ * (PK + 8)) * sizeof(float);
  int err = set_smem((const void*)rpe_pair_bwd_kernel<HD>, smem1);
  if (err != 0) return err;
  const int bands = (nQ + PQ - 1) / PQ;
  const int shares = (nK + keys_per_block - 1) / keys_per_block;
  const size_t elems = (size_t)B * nQ * H * HD;
  const bool vec = nK % 2 == 0 && ((uintptr_t)ds & 7) == 0 &&
                   ((uintptr_t)eg & 7) == 0;
  dim3 grid1(bands, B, shares);
  rpe_pair_bwd_kernel<HD><<<grid1, NT, smem1, stream>>>(
      k, v, key_valid, out, dout, logits, lse, shares > 1 ? dq_parts : dq,
      ds, eg, ds_absmax, drop, nQ, nK, keys_per_block,
      shares > 1 ? elems : 0, vec, aligned16(k) && aligned16(v),
      nK % 4 == 0 && aligned16(logits));
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (shares > 1) {
    const int blocks =
        (int)min((elems / 4 + 255) / 256, (size_t)SMS * 8);
    rpe_dq_sum_kernel<<<blocks, 256, 0, stream>>>(
        dq_parts, dq, elems, shares,
        aligned16(dq_parts) && aligned16(dq));
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  // table kernel: one block per (32 queries, batch row, corner pair,
  // share of the keys), each writing its slice of `slices`
  const size_t smem2 = (2 * 2 * (size_t)n * n * n * H + NW2 * ITEM_FLOATS +
                        TQ2 * 9) * sizeof(float);
  err = set_smem((const void*)rpe_table_bwd_kernel, smem2);
  if (err != 0) return err;
  const int qtiles2 = (nQ + TQ2 - 1) / TQ2;
  dim3 grid2(qtiles2, B,
             4 * ((nK + table_keys_per_block - 1) / table_keys_per_block));
  rpe_table_bwd_kernel<<<grid2, NT2, smem2, stream>>>(
      ds, corners, cossin, key_xyz, key_valid, ds_absmax, bands * B * shares,
      slices, nQ, nK, n, log_scale, max_value, table_keys_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// Every element of dq is written (zeros when there are no keys). A pair
// block takes keys_per_block keys (a multiple of 32), so the pair kernel
// runs shares = ceil(nK / keys_per_block) key shares; dq_parts is scratch
// for them, room for shares x (B, nQ, H, hd) floats, and may be null when
// shares is 1. ds_absmax is scratch for one float per pair block
// (ceil(nQ / 16) x B x shares). A table block takes table_keys_per_block
// keys (a multiple of 32): `slices` receives (B, ceil(nQ / 32),
// ceil(nK / table_keys_per_block)) slices of the 8 tables, each written
// whole, and rpe_table_sum.cu adds them into dtables. With no keys
// (nK = 0) nothing is written to them. A null seed means no dropout;
// key_offset is the global index of key 0, as the forward's.
// Returns cudaErrorInvalidValue (1) for a head count, head width or table
// size the kernels are not built for, or key splits they cannot take.
extern "C" int rpe_cross_attention_bwd_f32(
    const void* k, const void* v, const void* corners, const void* cossin,
    const void* key_xyz, const void* key_valid, const void* out,
    const void* dout, const void* logits, const void* lse, const void* seed,
    void* dq, void* dq_parts, void* ds_absmax, void* slices, void* ds,
    void* eg, int B, int nQ, int nK, int heads, int hd, int n,
    float log_scale, float max_value, int rotate, int keep_threshold,
    float drop_scale, int key_offset, int keys_per_block,
    int table_keys_per_block, void* stream) {
  // the item packing holds table indices up to 31
  if (heads != H || n > 31 || keys_per_block <= 0 || keys_per_block % PK ||
      table_keys_per_block <= 0 || table_keys_per_block % 32)
    return (int)cudaErrorInvalidValue;
  if (nK > keys_per_block && dq_parts == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || nQ <= 0) return (int)cudaGetLastError();
  if (nK <= 0)  // no keys: dQ is an empty sum
    return (int)cudaMemsetAsync(dq, 0, (size_t)B * nQ * H * hd * sizeof(float),
                                (cudaStream_t)stream);
  const float* cs = rotate ? (const float*)cossin : nullptr;
  const Dropout drop{(const long long*)seed, (uint32_t)keep_threshold,
                     drop_scale, (uint32_t)key_offset};
  auto args = [&](auto fn) {
    return fn((const float*)k, (const float*)v, (const float*)corners, cs,
              (const float*)key_xyz, (const uint8_t*)key_valid,
              (const float*)out, (const float*)dout, (const float*)logits,
              (const float*)lse, (float*)dq, (float*)dq_parts,
              (float*)ds_absmax, (float*)slices, (float*)ds, (float*)eg, drop,
              B, nQ, nK, n, log_scale, max_value, keys_per_block,
              table_keys_per_block, (cudaStream_t)stream);
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

