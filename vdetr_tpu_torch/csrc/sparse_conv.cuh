// Device code shared by the sparse-convolution kernels (Hopper).
//
// - conv_tile / store_tile: the f32 conv block's gather-GEMM over
//   neighbour rows it has resolved into shared memory, on the tensor cores
//   in split TF32 (three m16n8k8 MMAs per f32 product) behind a cp.async
//   ring, f32 accumulators; the bf16 form's is sparse_conv_sm90.cuh's
//   conv_tile_sm90 (wgmma behind an mbarrier ring). The keyed conv
//   (keyed_conv.cu) resolves the rows by binary search, the mapped conv
//   (mapped_conv.cu) reads them from a neighbour map; the GEMM is the
//   same, so the two are bit-equal.
// - dw_rulebook_kernel / dw_kernel (launch_dw): the weight gradient. The
//   rulebook compacts each offset's hits into an ordered list of (input
//   row, query row) pairs without atomics; the GEMM runs over the hits
//   only, on the tensor cores in split TF32 behind a cp.async ring, or,
//   where 27 C fits one tile (the stem), over every row with all 27
//   offsets in one block. The bf16 form's GEMM, bf16 features against
//   the f32 dout's two bf16 halves, is sparse_conv_sm90.cuh's
//   dw_bf16_kernel (wgmma behind an mbarrier ring) over the same
//   rulebook, dense at the stem's 8 padded channels. The keyed dW
//   (keyed_conv_dw.cu) finds the neighbours by binary search, the mapped
//   dW (mapped_conv_dw.cu) reads a (B, 27, V) map; the GEMM is the same,
//   so the two are bit-equal.
// - conv_sum_splits_kernel / dw_sum_splits_kernel: add a kernel's
//   partial sums in a fixed order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sparse_conv_sm90.cuh"
#include "tensor_core.cuh"

namespace sparse_conv {

constexpr int KV = 27;   // kernel volume

// f32 conv tiles (conv_tile): CONV_NT threads, 4 warps of 32 x 32
// outputs; the input channels per stage and the ring depth are template
// arguments
constexpr int CONV_NT = 128;
constexpr int BM = 64;      // query rows per block
constexpr int BN = 64;      // output channels per block
constexpr int BS = BN + 8;  // Bs row stride: B fragments conflict-free

__device__ __forceinline__ int lower_bound(const int* keys, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the TF32 tensor-core and cp.async pieces, shared with the flash-RPE
// backward's pair kernel (rpe_attention_bwd.cu)
using tc::aligned16;
using tc::cp_async16;
using tc::cp_async4;
using tc::cp_commit;
using tc::cp_wait;
using tc::mma_tf32;
using tc::split_tf32;

using bf16 = __nv_bfloat16;

// A thread's share of a 64 x 64 conv tile: warp w holds rows 32 (w & 1)
// + 16 mi + {g, g + 8} and columns 32 (w >> 1) + 8 ni + {2t, 2t + 1},
// g = lane / 4, t = lane % 4, as the m16n8 accumulator fragments.
struct ConvAcc {
  float c[2][4][4];
};

// acc += sum over the block's nk offsets of X[s_nbr[k][m]] @ w[k_begin +
// k], a row of -1 contributing 0. X is one batch row's (V_in, C) f32
// features, w the (27, C, Co) f32 weights. Offsets with no hit in the tile
// are skipped. The K loop runs over (offset with a hit, BK-channel chunk)
// through a STAGES-deep cp.async ring: gathered rows and the weight tile
// land in shared memory while the tensor cores work on an earlier stage.
// Each f32 operand is split into two TF32 halves (split_tf32) and
// multiplied in three m16n8k8 MMAs. Each stage's products are summed apart
// and added to the f32 accumulators with rounding f32 adds. a16 / b16: X
// rows / weight rows may be copied in 16-byte pieces (C resp. Co a
// multiple of 4, bases 16-byte aligned), otherwise in 4-byte copies (the
// stem's C = 3 rows are 12 bytes). A chunk multiplies its channels rounded
// up to the MMA's k (8). Every thread of the block calls it, after s_nbr
// is written and the block synchronized. (The bf16 form has its own body,
// sparse_conv_sm90.cuh.)
template <int BK, int STAGES>
__device__ __forceinline__ void conv_tile(const float* __restrict__ X,
                                          const float* __restrict__ w,
                                          int (*s_nbr)[BM], int k_begin,
                                          int nk, int C, int Co, int n0,
                                          bool a16, bool b16,
                                          ConvAcc& acc) {
  constexpr int KS = 8;  // k of one MMA
  // As row stride: A fragments conflict-free
  constexpr int AS = BK + 4;
  __shared__ __align__(16) float As[STAGES][BM][AS];
  __shared__ __align__(16) float Bs[STAGES][BK][BS];
  __shared__ int s_koff[KV];
  __shared__ int s_nkh;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;

  // the offsets with a hit in the tile, in order
  for (int k = warp; k < nk; k += CONV_NT / 32) {
    const bool hit = s_nbr[k][lane] >= 0 || s_nbr[k][lane + 32] >= 0;
    s_koff[k] = __any_sync(0xffffffffu, hit) ? 1 : 0;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < nk; ++k)
      if (s_koff[k]) s_koff[n++] = k;
    s_nkh = n;
  }
  __syncthreads();
  const int nchunks = (C + BK - 1) / BK;
  const int total = s_nkh * nchunks;
  // the channels K step `it` multiplies: its chunk's, rounded up to KS
  auto width = [&](int it) {
    return min(BK, (C - (it % nchunks) * BK + KS - 1) / KS * KS);
  };

  // issue the copies of K step `it` into ring slot `slot`
  auto load = [&](int it, int slot) {
    const int kk = s_koff[it / nchunks];
    const int c0 = (it % nchunks) * BK;
    const int kw = width(it);
    const int* nb = s_nbr[kk];
    if (a16) {
      for (int i = tid; i < BM * kw / 4; i += CONV_NT) {
        const int m = i / (kw / 4), c = (i % (kw / 4)) * 4;
        const int r = nb[m];
        const bool p = r >= 0 && c0 + c < C;
        cp_async16(&As[slot][m][c], p ? X + (size_t)r * C + c0 + c : X, p);
      }
    } else {
      for (int i = tid; i < BM * kw; i += CONV_NT) {
        const int m = i / kw, c = i % kw;
        const int r = nb[m];
        const bool p = r >= 0 && c0 + c < C;
        cp_async4(&As[slot][m][c], p ? X + (size_t)r * C + c0 + c : X, p);
      }
    }
    const float* Wk = w + ((size_t)(k_begin + kk) * C + c0) * Co + n0;
    if (b16) {
      for (int i = tid; i < kw * BN / 4; i += CONV_NT) {
        const int c = i / (BN / 4), n = (i % (BN / 4)) * 4;
        const bool p = c0 + c < C && n0 + n < Co;
        cp_async16(&Bs[slot][c][n], p ? Wk + (size_t)c * Co + n : w, p);
      }
    } else {
      for (int i = tid; i < kw * BN; i += CONV_NT) {
        const int c = i / BN, n = i % BN;
        const bool p = c0 + c < C && n0 + n < Co;
        cp_async4(&Bs[slot][c][n], p ? Wk + (size_t)c * Co + n : w, p);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s, s);
    cp_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // step `it` landed; step it - 1's slot is free
    if (it + STAGES - 1 < total)
      load(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_commit();
    const int slot = it % STAGES;
    const int nks = width(it) / KS;
    // the stage's products go to a partial sum started at 0, added to acc
    // with f32 adds: the tensor cores' own accumulation does not round to
    // nearest, so a long chain of MMAs into one large sum drifts
    float part[2][4][4];
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < BK / KS; ++ks) {
      if (ks == nks) break;
      const int kb = ks * KS;
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* a0 = &As[slot][wm + mi * 16 + g][kb + t];
        const float* a1 = a0 + 8 * AS;
        split_tf32(a0[0], ah[mi][0], al[mi][0]);
        split_tf32(a1[0], ah[mi][1], al[mi][1]);
        split_tf32(a0[4], ah[mi][2], al[mi][2]);
        split_tf32(a1[4], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* b0 = &Bs[slot][kb + t][wn + ni * 8 + g];
        split_tf32(b0[0], bh[ni][0], bl[ni][0]);
        split_tf32(b0[4 * BS], bh[ni][1], bl[ni][1]);
      }
      // the small cross terms first, then hi * hi
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float(&p)[4] = part[mi][ni];
          if (ks == 0)
            mma_tf32(p, al[mi], bh[ni], zero);
          else
            mma_tf32(p, al[mi], bh[ni], p);
          mma_tf32(p, ah[mi], bl[ni], p);
          mma_tf32(p, ah[mi], bh[ni], p);
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc.c[mi][ni][e] += part[mi][ni][e];
  }
  cp_wait<0>();  // no copy may outlive the block's shared memory
}

// out[m0 + row, n0 + col] = acc for the rows < V and columns < Co; out is
// one batch row's (V, Co) output.
__device__ __forceinline__ void store_tile(float* __restrict__ out, int V,
                                           int Co, int m0, int n0,
                                           const ConvAcc& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mi * 16 + g + 8 * h;
      if (row >= V) continue;
      float* o = out + (size_t)row * Co;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * t;
        if (col < Co) o[col] = acc.c[mi][ni][2 * h];
        if (col + 1 < Co) o[col + 1] = acc.c[mi][ni][2 * h + 1];
      }
    }
}

// --- the weight gradient (dw_rulebook_kernel, dw_kernel) ---

// dw_kernel's views of where row r = b * V + v finds its input row for
// offset k: entry(k, r) points at the raw map entry, resolve(raw, r) turns
// it into a global input row b * V_in + i, or -1 for none; BatchMap's
// operator() is both (the mapped dW's rulebook lookup). The bf16 form's
// dense producer takes them apart, one division a row: entry(k, r) =
// row_entry(r) + k * kstride(), resolve(raw, r) = resolve_at(raw,
// row_base(r)).
// - FlatMap: the keyed dW's private (27, rows) map of global rows, -1 for
//   none (keyed_conv_dw.cu);
// - BatchMap: a (B, 27, V) map of local rows, V_in (or anything outside
//   [0, V_in)) for a miss (kernel G's, mapped_conv_dw.cu).
struct FlatMap {
  const int* nbr;
  int rows;
  __device__ __forceinline__ const int* entry(int k, int r) const {
    return nbr + (size_t)k * rows + r;
  }
  __device__ __forceinline__ int resolve(int raw, int) const { return raw; }
  __device__ __forceinline__ const int* row_entry(int r) const {
    return nbr + r;
  }
  __device__ __forceinline__ size_t kstride() const { return rows; }
  __device__ __forceinline__ int row_base(int) const { return 0; }
  __device__ __forceinline__ int resolve_at(int raw, int) const {
    return raw;
  }
};

struct BatchMap {
  const int* nbr;
  int V, V_in;
  __device__ __forceinline__ const int* entry(int k, int r) const {
    const int b = r / V, v = r - b * V;
    return nbr + ((size_t)b * KV + k) * V + v;
  }
  __device__ __forceinline__ int resolve(int raw, int r) const {
    return (raw >= 0 && raw < V_in) ? (r / V) * V_in + raw : -1;
  }
  __device__ __forceinline__ int operator()(int k, int r) const {
    return resolve(*entry(k, r), r);
  }
  __device__ __forceinline__ const int* row_entry(int r) const {
    return entry(0, r);
  }
  __device__ __forceinline__ size_t kstride() const { return V; }
  __device__ __forceinline__ int row_base(int r) const {
    return (r / V) * V_in;
  }
  __device__ __forceinline__ int resolve_at(int raw, int base) const {
    return (raw >= 0 && raw < V_in) ? base + raw : -1;
  }
};

constexpr int DW_NT = 128;       // 4 warps, 2 (dW rows) x 2 (dW columns)
constexpr int DW_BR = 32;        // rows per stage: the K depth of a stage
constexpr int DW_STAGES = 3;     // cp.async ring depth
constexpr int DW_BC = 64;        // dW rows (input channels) per block
constexpr int DW_BO = 64;        // dW columns (output channels) per block
constexpr int DW_DS = DW_BO + 8; // Ds row stride: fragments conflict-free
constexpr int DW_DENSE_M = 96;   // dW rows per block in the dense form
constexpr int RB_NT = 1024;      // rulebook threads per block

// Whether the weight gradient takes the dense form: a block owns all 27
// offsets of its rows (dW as one (27 C, Co) matrix), because 27 C fits one
// tile (the stem's C = 3: 81 of 96 rows). Otherwise the per-offset form:
// a block owns one offset's 64 x 64 dW tile over the offset's hits.
__host__ __device__ inline bool dw_dense(int C) {
  return KV * C <= DW_DENSE_M;
}

// Dynamic shared memory of a dw_kernel block: the A ring (rows x dW
// rows), the B ring (rows x 64) and the index ring (per row: the 27 raw
// map entries in the dense form, the input and query row otherwise).
inline size_t dw_smem_bytes(bool dense) {
  const int as = (dense ? DW_DENSE_M : DW_BC) + 8;
  return sizeof(float) * DW_STAGES * DW_BR * as +
         sizeof(float) * DW_STAGES * DW_BR * DW_DS +
         sizeof(int) * DW_STAGES * (dense ? KV : 2) * DW_BR;
}

// The rulebook of the per-offset form: for offset k and row split s, the
// (input row, query row) pairs that hit, ascending in the query row, at
// seg = (k * splits + s) * rows_per_split of `src` and `row`, and their
// count at count[k * splits + s]. One block per (split, offset) walks its
// rows in order, RB_NT at a time, placing each hit by a block-wide scan of
// the hit flags (warp ballots): no atomics, so every call writes the same
// lists. Lookup: nbr(k, r), a global input row or -1.
template <class Lookup>
__global__ void __launch_bounds__(RB_NT)
dw_rulebook_kernel(Lookup nbr, int rows, int rows_per_split,
                   int* __restrict__ src, int* __restrict__ row,
                   int* __restrict__ count) {
  static_assert(RB_NT == 32 * 32, "one warp scans the warp counts");
  __shared__ int s_warp[RB_NT / 32];
  __shared__ int s_total;
  const int s = blockIdx.x, k = blockIdx.y, splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r_begin = s * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);
  const size_t seg = ((size_t)k * splits + s) * rows_per_split;
  int n = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += RB_NT) {
    const int r = r0 + tid;
    const int i = r < r_end ? nbr(k, r) : -1;
    const unsigned hits = __ballot_sync(0xffffffffu, i >= 0);
    if (lane == 0) s_warp[warp] = __popc(hits);
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the 32 warp counts
      const int c = s_warp[lane];
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      s_warp[lane] = incl - c;
      if (lane == 31) s_total = incl;
    }
    __syncthreads();
    if (i >= 0) {
      const int pos = n + s_warp[warp] + __popc(hits & ((1u << lane) - 1u));
      src[seg + pos] = i;
      row[seg + pos] = r;
    }
    n += s_total;
    __syncthreads();  // s_warp and s_total are written again next round
  }
  if (tid == 0) count[k * splits + s] = n;
}

// dW = sum over rows r of feats[nbr_k(r)]^T dout[r], f32 (27, C, Co), or
// the split's partial, on the tensor cores in split TF32 (conv_tile's
// recipe, three m16n8k8 MMAs per f32 product; each 32-row stage's MMAs
// start from 0 and the stage's partial is added to the accumulators with
// f32 adds) behind a DW_STAGES-deep cp.async ring that carries each
// stage's indices one ring ahead of its rows. (The bf16 form has its own
// body, sparse_conv_sm90.cuh's dw_bf16_kernel.)
// - DENSE (dw_dense(C)): grid (Co tiles, 1, splits); a block walks the
//   rows of its split and gathers, per row, all 27 neighbours' C channels
//   into one A row of 27 C (<= 96) values, zero at a miss: dout is read
//   once for all offsets. `map` gives the neighbours.
// - per offset: grid (C tiles x Co tiles, 27, splits); a block walks its
//   offset's rulebook segment (dw_rulebook_kernel), hits only, 32 at a
//   time; the last stage's missing rows are zero.
// feats (B * V_in, C) f32, dout (rows, Co) f32, dw (splits, 27, C, Co);
// a16 / b16: feats / dout rows may be copied in 16-byte pieces.
template <bool DENSE, class Map>
__global__ void __launch_bounds__(DW_NT)
dw_kernel(const float* __restrict__ feats, const float* __restrict__ dout,
          Map map, const int* __restrict__ src, const int* __restrict__ row,
          const int* __restrict__ count, float* __restrict__ dw, int rows,
          int C, int Co, int rows_per_split, bool a16, bool b16) {
  constexpr int EPC = 4;  // elements per 16-byte copy
  constexpr int MI = DENSE ? 3 : 2;  // m16 tiles per warp
  constexpr int BM = 32 * MI;        // dW rows per block
  constexpr int AS = BM + 8;         // As row stride: fragments conflict-free
  constexpr int DS = DW_DS;
  constexpr int NIDX = DENSE ? KV : 2;
  static_assert(BM == (DENSE ? DW_DENSE_M : DW_BC), "tile rows");
  extern __shared__ __align__(16) unsigned char dw_smem[];
  float(*As)[DW_BR][AS] = reinterpret_cast<float(*)[DW_BR][AS]>(dw_smem);
  float(*Ds)[DW_BR][DS] = reinterpret_cast<float(*)[DW_BR][DS]>(
      dw_smem + sizeof(float) * DW_STAGES * DW_BR * AS);
  int(*Ix)[NIDX][DW_BR] = reinterpret_cast<int(*)[NIDX][DW_BR]>(
      dw_smem + sizeof(float) * DW_STAGES * DW_BR * AS +
      sizeof(float) * DW_STAGES * DW_BR * DS);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 16 * MI, wn = (warp >> 1) * 32;
  const int n_otiles = (Co + DW_BO - 1) / DW_BO;
  const int o0 = (blockIdx.x % n_otiles) * DW_BO;
  const int c0 = DENSE ? 0 : (blockIdx.x / n_otiles) * DW_BC;
  const int k = DENSE ? 0 : blockIdx.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const int r_begin = split * rows_per_split;
  const size_t seg = ((size_t)k * splits + split) * rows_per_split;
  // this block's entries: its rows (dense) or its offset's hits
  const int n = DENSE ? max(0, min(rows, r_begin + rows_per_split) - r_begin)
                      : count[k * splits + split];
  const int total = (n + DW_BR - 1) / DW_BR;
  const int mk = KV * C;  // dense: the used columns of an A row

  if constexpr (DENSE) {  // A's columns past 27 C are never copied: zero
    for (int i = tid; i < DW_STAGES * DW_BR * (BM - mk); i += DW_NT) {
      const int st = i / (DW_BR * (BM - mk)), rem = i % (DW_BR * (BM - mk));
      As[st][rem / (BM - mk)][mk + rem % (BM - mk)] = 0.f;
    }
  }

  // the indices of stage j into ring slot j % DW_STAGES
  auto load_idx = [&](int j) {
    const int slot = j % DW_STAGES, e0 = j * DW_BR;
    if constexpr (DENSE) {
      for (int i = tid; i < KV * DW_BR; i += DW_NT) {
        const int kk = i / DW_BR, e = i % DW_BR;
        const bool p = e0 + e < n;
        cp_async4(&Ix[slot][kk][e],
                  p ? (const void*)map.entry(kk, r_begin + e0 + e) : dout, p);
      }
    } else {  // 16-byte pieces: segments and stages are 128-byte aligned
      if (tid < 2 * DW_BR / 4) {
        const int w = tid / (DW_BR / 4), e = (tid % (DW_BR / 4)) * 4;
        const bool p = e0 + e < n;
        cp_async16(&Ix[slot][w][e], (w ? row : src) + seg + e0 + e, p);
      }
    }
  };

  // the A and B rows of stage j into ring slot j % DW_STAGES, once its
  // indices are in shared memory
  auto load_data = [&](int j) {
    const int slot = j % DW_STAGES, e0 = j * DW_BR;
    if constexpr (DENSE) {
      for (int i = tid; i < DW_BR * mk; i += DW_NT) {
        const int e = i / mk, m = i - e * mk;
        const int kk = m / C, c = m - kk * C;
        const int r = r_begin + e0 + e;
        const int s = e0 + e < n ? map.resolve(Ix[slot][kk][e], r) : -1;
        cp_async4(&As[slot][e][m],
                  s >= 0 ? (const void*)(feats + (size_t)s * C + c) : dout,
                  s >= 0);
      }
    } else if (a16) {
      for (int i = tid; i < DW_BR * BM / EPC; i += DW_NT) {
        const int e = i / (BM / EPC), c = (i % (BM / EPC)) * EPC;
        const bool p = e0 + e < n && c0 + c < C;
        const int s = p ? Ix[slot][0][e] : 0;
        cp_async16(&As[slot][e][c],
                   p ? (const void*)(feats + (size_t)s * C + c0 + c) : dout,
                   p);
      }
    } else {
      for (int i = tid; i < DW_BR * BM; i += DW_NT) {
        const int e = i / BM, c = i % BM;
        const bool p = e0 + e < n && c0 + c < C;
        const int s = p ? Ix[slot][0][e] : 0;
        cp_async4(&As[slot][e][c],
                  p ? (const void*)(feats + (size_t)s * C + c0 + c) : dout,
                  p);
      }
    }
    auto drow = [&](int e) {
      return DENSE ? r_begin + e0 + e : Ix[slot][1][e];
    };
    if (b16) {
      for (int i = tid; i < DW_BR * DW_BO / 4; i += DW_NT) {
        const int e = i / (DW_BO / 4), o = (i % (DW_BO / 4)) * 4;
        const bool p = e0 + e < n && o0 + o < Co;
        cp_async16(&Ds[slot][e][o],
                   p ? dout + (size_t)drow(e) * Co + o0 + o : dout, p);
      }
    } else {
      for (int i = tid; i < DW_BR * DW_BO; i += DW_NT) {
        const int e = i / DW_BO, o = i % DW_BO;
        const bool p = e0 + e < n && o0 + o < Co;
        cp_async4(&Ds[slot][e][o],
                  p ? dout + (size_t)drow(e) * Co + o0 + o : dout, p);
      }
    }
  };

  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // group G_j = {rows of stage j, indices of stage j + DW_STAGES - 1}:
  // when G_j has landed, stage j can be multiplied and stage j +
  // DW_STAGES - 1's rows can be issued
  for (int j = 0; j < DW_STAGES - 1; ++j)
    if (j < total) load_idx(j);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  for (int j = 0; j < DW_STAGES - 1; ++j) {
    if (j < total) load_data(j);
    if (j + DW_STAGES - 1 < total) load_idx(j + DW_STAGES - 1);
    cp_commit();
    __syncthreads();  // slot j's indices read before a later copy lands
  }
  for (int it = 0; it < total; ++it) {
    cp_wait<DW_STAGES - 2>();
    __syncthreads();  // stage it landed; stage it - 1's slots are free
    if (it + DW_STAGES - 1 < total) load_data(it + DW_STAGES - 1);
    if (it + 2 * DW_STAGES - 2 < total) load_idx(it + 2 * DW_STAGES - 2);
    cp_commit();
    const int slot = it % DW_STAGES;
    float part[MI][4][4];
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < DW_BR / 8; ++ks) {
      const int kb = ks * 8;
      uint32_t ah[MI][4], al[MI][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {  // A[m][r] = As[r][m]
        const float* a0 = &As[slot][kb + t][wm + mi * 16 + g];
        const float* a1 = a0 + 4 * AS;
        split_tf32(a0[0], ah[mi][0], al[mi][0]);
        split_tf32(a0[8], ah[mi][1], al[mi][1]);
        split_tf32(a1[0], ah[mi][2], al[mi][2]);
        split_tf32(a1[8], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* b0 = &Ds[slot][kb + t][wn + ni * 8 + g];
        split_tf32(b0[0], bh[ni][0], bl[ni][0]);
        split_tf32(b0[4 * DS], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float(&p)[4] = part[mi][ni];
          if (ks == 0)
            mma_tf32(p, al[mi], bh[ni], zero);
          else
            mma_tf32(p, al[mi], bh[ni], p);
          mma_tf32(p, ah[mi], bl[ni], p);
          mma_tf32(p, ah[mi], bh[ni], p);
        }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }
  cp_wait<0>();  // no copy may outlive the block's shared memory

  // dense: tile row m is dW row m of the (27 C, Co) matrix
  float* out = dw + ((size_t)split * KV + k) * C * Co;
  const int m_lim = DENSE ? mk : C - c0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm + mi * 16 + g + 8 * h;
      if (m >= m_lim) continue;
      float* o = out + (size_t)(c0 + m) * Co;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = o0 + wn + ni * 8 + 2 * t;
        if (col < Co) o[col] = acc[mi][ni][2 * h];
        if (col + 1 < Co) o[col + 1] = acc[mi][ni][2 * h + 1];
      }
    }
}

// Ints of a weight gradient's rulebook (per-offset form): src and row,
// (27, splits * rows_per_split) each, then count (27, splits).
inline size_t dw_rulebook_ints(int splits, int rows_per_split) {
  return (size_t)KV * splits * (2 * (size_t)rows_per_split + 1);
}

// Whether a form's weight gradient takes its dense form (no rulebook):
// the f32 form's dw_dense, the bf16 form's sparse_conv_sm90::dw_dense.
template <typename T>
inline bool dw_dense_form(int C) {
  return std::is_same<T, float>::value ? dw_dense(C)
                                       : sparse_conv_sm90::dw_dense(C);
}

// Launches the weight gradient of one conv into `dst` ((splits, 27, C,
// Co)): the rulebook (per-offset form; `lookup` finds the neighbours, the
// lists go to `rb`, dw_rulebook_ints of them), then the GEMM, which in
// the dense form reads `map` instead. T: the features' type, float
// (dw_kernel) or bf16 (sparse_conv_sm90.cuh's dw_bf16_kernel: C a
// multiple of 8, Co of 4, both rows 16-byte aligned). Returns the first
// launch error.
template <typename T, class Lookup, class Map>
inline cudaError_t launch_dw(const T* feats, const float* dout,
                             Lookup lookup, Map map, int* rb, float* dst,
                             int rows, int C, int Co, int splits,
                             int rows_per_split, cudaStream_t st) {
  constexpr bool F32 = std::is_same<T, float>::value;
  if (!F32 && (C % 8 || Co % 4 || !aligned16(feats) || !aligned16(dout)))
    return cudaErrorInvalidValue;
  int* src = rb;
  int* row = src + (size_t)KV * splits * rows_per_split;
  int* count = row + (size_t)KV * splits * rows_per_split;
  if (!dw_dense_form<T>(C))
    dw_rulebook_kernel<<<dim3(splits, KV), RB_NT, 0, st>>>(
        lookup, rows, rows_per_split, src, row, count);
  if constexpr (!F32) {
    return sparse_conv_sm90::launch_dw_bf16(feats, dout, map, src, row,
                                            count, dst, rows, C, Co, splits,
                                            rows_per_split, st);
  } else {
    const bool dense = dw_dense(C);
    const size_t smem = dw_smem_bytes(dense);
    const bool a16 = C % 4 == 0 && aligned16(feats);
    const bool b16 = Co % 4 == 0 && aligned16(dout);
    const int otiles = (Co + DW_BO - 1) / DW_BO;
    if (dense) {
      const cudaError_t err = cudaFuncSetAttribute(
          dw_kernel<true, Map>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return err;
      dw_kernel<true, Map><<<dim3(otiles, 1, splits), DW_NT, smem, st>>>(
          feats, dout, map, nullptr, nullptr, nullptr, dst, rows, C, Co,
          rows_per_split, a16, b16);
      return cudaGetLastError();
    }
    const cudaError_t err = cudaFuncSetAttribute(
        dw_kernel<false, Map>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const int ctiles = (C + DW_BC - 1) / DW_BC;
    dw_kernel<false, Map><<<dim3(ctiles * otiles, KV, splits), DW_NT, smem,
                            st>>>(feats, dout, map, src, row, count, dst,
                                  rows, C, Co, rows_per_split, a16, b16);
    return cudaGetLastError();
  }
}

// out = sum of the `splits` partials, in split order; two kernels of one
// body, so that a profile tells the conv's sums (A, H) from the weight
// gradient's (D, I)
__device__ __forceinline__ void sum_splits_body(const float* __restrict__ part,
                                                float* __restrict__ out,
                                                size_t n, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = part[i];
    for (int s = 1; s < splits; ++s) acc += part[(size_t)s * n + i];
    out[i] = acc;
  }
}

__global__ void conv_sum_splits_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, size_t n,
                                       int splits) {
  sum_splits_body(part, out, n, splits);
}

__global__ void dw_sum_splits_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, size_t n,
                                     int splits) {
  sum_splits_body(part, out, n, splits);
}

inline void conv_sum_splits(const float* part, float* out, size_t n,
                            int splits, cudaStream_t st) {
  conv_sum_splits_kernel<<<264, 512, 0, st>>>(part, out, n, splits);
}

inline void dw_sum_splits(const float* part, float* out, size_t n,
                          int splits, cudaStream_t st) {
  dw_sum_splits_kernel<<<264, 512, 0, st>>>(part, out, n, splits);
}

}  // namespace sparse_conv
