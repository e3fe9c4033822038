// The bf16 forms of the sparse-conv tile GEMM (kernels A and H under
// compute_dtype="bfloat16") and of its weight gradient's GEMM (kernels D
// and I), designed for Hopper: wgmma behind an mbarrier ring, a producer
// warpgroup feeding the consumer warpgroups. The weight gradient's body,
// dw_bf16_kernel, has its own note below.
//
// Function, per query row v of a block's row tile and the block's share of
// the 27 offsets: out[v, n0:n0+64 NB] = sum_k X[nbr(v, k)] @ W[k][:, n0:],
// bf16 operands, f32 accumulation, a miss (nbr -1) contributing 0.
//
// What bounded the mma.sync form it replaces (64 x 64 tiles, 32-channel
// stages two deep, a block-wide __syncthreads per step for 16 MMAs a
// warp): the K loop's exposed latency, not the tensor cores. On an H100
// (700 W) the MMAs removed, that loop kept 86% of its time at 512 -> 512
// and 65% at 64 -> 64; gathers that read consecutive rows instead took
// as long as the real ones. What bounds this form: the latency of a
// stage's copies (rows from L2, weights by TMA) against the stages in
// flight, and in kernel A the binary searches before the loop. Design:
// - the contraction runs over the split's offsets flattened to K =
//   nk * C and cut into 64-wide stages: a stage is one 64-channel chunk of
//   one offset where C is a multiple of 64, or several offsets' channels
//   (the stem's 8 padded channels: eight offsets a stage);
// - a stage is the gathered feature rows of the block's row tile (128
//   bytes a row, 16-byte cp.async copies by the producer warpgroup into
//   the 128-byte swizzle, zero-filled for misses, so a miss reads nothing)
//   and a 64 x 64 NB tile of the weights viewed as a (27 C, Co) matrix: a
//   dense box, loaded by TMA in 64-column boxes with the same swizzle;
//   STAGES of them in a ring in dynamic shared memory (two blocks an SM);
// - per stage a full and an empty mbarrier: the producers arrive on full
//   as their copies land (cp.async.mbarrier.arrive.noinc) and one adds
//   the TMA bytes (expect_tx); each consumer warpgroup waits on full,
//   issues four wgmma m64n64k16 (A K-major, B MN-major, both from shared
//   memory) on its 64 x 64 of the tile, waits for them and arrives on
//   empty. No block-wide barrier in the loop;
// - a block computes 128 rows x 64 channels where Co <= 64, else 64 x 128,
//   so that either the weight tile (the former) or the gathered rows and
//   their lookup (the latter) serve two warpgroups; a stage with no hit in
//   the tile is skipped;
// - each stage's wgmma chain starts from 0 (scale-d 0) and its sum is
//   added to the running f32 accumulator with a rounding f32 add: the
//   tensor cores' accumulation truncates, so one long chain would drift;
// - where the offsets are split over blocks (the deep levels, few live
//   tiles), a tile with no hit in a split writes no partial and flags it,
//   and the fixed-order sum of the splits skips it.
// A row's result is the f32 sum, in stage order, of its stage sums; a
// stage where the row has no hit contributes an exact zero, so the rows
// around it in the tile and the skipped stages leave its bits unchanged
// (tests/test_torch_kernel_premises.py emulates the sums).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sparse_conv_sm90 {

using bf16 = __nv_bfloat16;

constexpr int KV = 27;       // kernel volume
constexpr int BK = 64;       // K per stage: a 128-byte bf16 row
constexpr int STAGES = 4;    // ring depth
constexpr int PT = 128;      // producer threads: one warpgroup
constexpr int A_BYTES = 64 * BK * 2;      // one 64-row A tile, 8 KB
constexpr int BOX_BYTES = BK * 64 * 2;    // one 64 x 64 weight box, 8 KB

// A block's output tile is MT x 64 rows by NB x 64 channels, one consumer
// warpgroup per 64 x 64 (MT * NB = 2 in the launches: 128 x 64 where
// Co <= 64, else 64 x 128), then the producer warpgroup.
template <int MT, int NB>
__host__ __device__ constexpr int threads() {
  return 128 * MT * NB + PT;
}

// dynamic shared memory of a block: the A and B rings (1024-byte aligned
// for the 128-byte swizzle), the full and empty mbarriers, then the list
// of live stages; `live_cap` ints
template <int MT, int NB>
__host__ __device__ constexpr int ring_bytes() {
  return STAGES * (MT * A_BYTES + NB * BOX_BYTES);
}

template <int MT, int NB>
inline size_t smem_bytes(int live_cap) {
  return 1024 + ring_bytes<MT, NB>() + 2 * STAGES * 8 +
         4 * (size_t)live_cap;
}

// the stages of one split: K = nk * C, 64 a stage
__host__ __device__ inline int num_stages(int nk, int C) {
  return (nk * C + BK - 1) / BK;
}

// --- PTX pieces ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed; a phase that never
// completes (a lost copy) traps after ~2^24 polls instead of hanging the
// card (fps.cu's guard)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (unsigned polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 24)) __trap();
  }
}

// 16 bytes global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::
                   "r"(bar)
               : "memory");
}

// a (64 rows, 64 columns) box of a 2-D tensor map at (column x, row y)
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int x,
                                            int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// the compiler may not move accesses of the accumulator registers across
// the wgmma issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) = (scale_d ? d : 0) + A (64 x 16) . B (16 x 64, MN-major),
// bf16 operands from shared memory; A K-major (TRANS_A 0: the conv's
// gathered rows) or MN-major (TRANS_A 1: the weight gradient's gathered
// feature rows, stored hit by hit with the channels contiguous)
#define SC90_R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])

template <int TRANS_A>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, 1;\n}"
      : SC90_R8(0), SC90_R8(8), SC90_R8(16), SC90_R8(24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A));
}

#undef SC90_R8

// --- the tile GEMM ---

// out[m0 + row, n0 + col] (one batch row's (V, Co) f32 output, rows < V
// and columns < Co) = the tile's sum over the split's live stages. X is one
// batch row's (V_in, C) bf16 features; `wmap` the weights (27 C, Co) as a
// tensor map of 64 x 64 boxes with the 128-byte swizzle; s_nbr[kk][m] the
// input row of query row m0 + m for offset k_begin + kk, or -1. With
// `live_flag` (an offset split's partial), *live_flag = whether the tile
// has a live stage, and a tile without one writes nothing. Every thread of
// the block calls it, after s_nbr is written and the block synchronized;
// `smem` is the block's dynamic shared memory.
template <int MT, int NB>
__device__ __forceinline__ void conv_tile_sm90(
    const bf16* __restrict__ X, const CUtensorMap* wmap,
    const int (*s_nbr)[64 * MT], int k_begin, int nk, int C, int Co, int n0,
    int m0, int V, float* __restrict__ out, int* live_flag, uint8_t* smem) {
  constexpr int NT = threads<MT, NB>();
  constexpr int CT = NT - PT;  // consumer threads
  constexpr int ROWS = 64 * MT;
  constexpr int STAGE_A = MT * A_BYTES, STAGE_B = NB * BOX_BYTES;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  uint8_t* base = (uint8_t*)(((uintptr_t)smem + 1023) & ~(uintptr_t)1023);
  const uint32_t a_ring = smem_u32(base);
  const uint32_t b_ring = a_ring + STAGES * STAGE_A;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + ring_bytes<MT, NB>());
  const uint32_t full = smem_u32(bars), empty = full + STAGES * 8;
  int* live = reinterpret_cast<int*>(bars + 2 * STAGES);
  __shared__ int s_hit[KV];
  __shared__ int s_nlive;

  // the offsets with a hit in the tile
  for (int kk = warp; kk < nk; kk += NT / 32) {
    bool hit = false;
#pragma unroll
    for (int m = lane; m < ROWS; m += 32) hit |= s_nbr[kk][m] >= 0;
    const bool any = __any_sync(0xffffffffu, hit);
    if (lane == 0) s_hit[kk] = any;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, PT + 1);  // the producers + the TMA arrive
      mbar_init(empty + 8 * s, CT);     // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the stages that touch an offset with a hit, in order: flags, then
  // warp 0 compacts them in place
  const int nst = num_stages(nk, C);
  for (int j = tid; j < nst; j += NT) {
    const int k0 = j * BK / C, k1 = min(nk - 1, (j * BK + BK - 1) / C);
    int hit = 0;
    for (int kk = k0; kk <= k1; ++kk) hit |= s_hit[kk];
    live[j] = hit;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int j0 = 0; j0 < nst; j0 += 32) {
      const int j = j0 + lane;
      const bool f = j < nst && live[j] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (f) live[n + __popc(bal & ((1u << lane) - 1))] = j;
      n += __popc(bal);
      __syncwarp();
    }
    if (lane == 0) s_nlive = n;
  }
  __syncthreads();
  const int nlive = s_nlive;
  // a split's block with no live stage leaves its partial unwritten and
  // says so (conv_sum_live_splits skips it)
  if (live_flag != nullptr) {
    if (tid == 0) *live_flag = nlive > 0;
    if (nlive == 0) return;
  }

  if (tid >= CT) {
    // producers: thread p copies chunk q = p % 8 (8 channels, 16 bytes) of
    // rows p / 8, p / 8 + 16, ... of each stage's A tile (MT 64-row tiles,
    // one after the other)
    const int p = tid - CT, q = p & 7;
    for (int i = 0; i < nlive; ++i) {
      const int slot = i % STAGES;
      if (i >= STAGES) mbar_wait(empty + 8 * slot, ((i / STAGES) - 1) & 1);
      const int j = live[i];
      const int kidx = j * BK + q * 8;  // K index of the chunk in the split
      const int kk = kidx / C, c = kidx - kk * C;
      const int* nb = s_nbr[kk < nk ? kk : 0];
      const uint32_t a = a_ring + slot * STAGE_A;
#pragma unroll
      for (int m = p >> 3; m < ROWS; m += PT / 8) {
        const int r = kk < nk ? nb[m] : -1;
        cp_async16(a + m * 128 + ((q ^ (m & 7)) << 4),
                   r >= 0 ? X + (size_t)r * C + c : X, r >= 0);
      }
      if (p == 0) {
        const uint32_t bar = full + 8 * slot;
        mbar_expect_tx(bar, STAGE_B);
        const uint32_t b = b_ring + slot * STAGE_B;
#pragma unroll
        for (int h = 0; h < NB; ++h)
          tma_load_2d(b + h * BOX_BYTES, wmap, n0 + 64 * h,
                      k_begin * C + j * BK, bar);
      }
      cp_async_arrive(full + 8 * slot);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // consumer warpgroup wg: rows 64 mt, channels 64 nb of the block's tile;
  // per stage four k16 steps into `part` (from 0), then acc += part
  const int wg = warp >> 2, mt = wg / NB, nb = wg % NB;
  float acc[32], part[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = part[e] = 0.f;
  for (int i = 0; i < nlive; ++i) {
    const int slot = i % STAGES;
    mbar_wait(full + 8 * slot, (i / STAGES) & 1);
    // the gathered rows were written by cp.async (the generic proxy);
    // wgmma reads shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint32_t a = a_ring + slot * STAGE_A + mt * A_BYTES;
    const uint32_t b = b_ring + slot * STAGE_B + nb * BOX_BYTES;
    fence_regs(part);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int s = 0; s < BK / 16; ++s)
      // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart, k16
      // steps 32 bytes along the row; B: the warpgroup's 64-column box,
      // MN-major, 8-row K groups 1024 bytes apart, k16 steps 2 KB down
      wgmma64<0>(part, desc_sw128(a + 32 * s, 16, 1024),
              desc_sw128(b + 2048 * s, BOX_BYTES, 1024), s > 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(part);
    mbar_arrive(empty + 8 * slot);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += part[e];
  }

  // the accumulator fragment: warp w of the warpgroup holds rows 16 w + g
  // and 16 w + g + 8 (g = lane / 4), columns 8 j + 2 t and + 1 (t = lane %
  // 4) in acc[4 j .. 4 j + 3]
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + 64 * mt + 16 * (warp & 3) + g + 8 * h;
    if (row >= V) continue;
    float* o = out + (size_t)row * Co;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 64 * nb + 8 * j + 2 * t;
      if (col + 1 < Co)
        *reinterpret_cast<float2*>(o + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      else if (col < Co)
        o[col] = acc[4 * j + 2 * h];
    }
  }
}

// out = the sum, in split order, of the live partials: part (splits, B, V,
// Co), flag (splits, B, V / rows rounded up) from conv_tile_sm90's tiles
// of `rows` rows; a thread per 4 columns of a row (Co a multiple of 8). A skipped partial is +0 in
// every entry (its tile had no hit), and no partial is -0 (each is an f32
// sum started from +0), so the skip leaves the bits of the sum of all of
// them.
__global__ void conv_sum_live_splits_kernel(const float* __restrict__ part,
                                            const int* __restrict__ flag,
                                            float* __restrict__ out, int B,
                                            int V, int Co, int splits,
                                            int rows) {
  const int q4 = Co / 4, tiles = (V + rows - 1) / rows;
  const int n4 = B * V * q4;
  const size_t n = (size_t)B * V * Co;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    const int r = i / q4;  // b * V + row
    const int b = r / V, tile = (r - b * V) / rows;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      if (!flag[(s * B + b) * tiles + tile]) continue;
      const float4 p = reinterpret_cast<const float4*>(part + s * n)[i];
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    reinterpret_cast<float4*>(out)[i] = acc;
  }
}

// --- the weight gradient (kernels D and I, bf16 form) ---
//
// Function: dW[k] = sum over the hits (s, r) of offset k of feats[s]^T
// dout[r], bf16 features, f32 dout taken as its two bf16 halves (the JAX
// package multiplies the f32 cotangent by the bf16 features), f32 sums.
// What bounded the mma.sync form it replaces (32-hit stages three deep, a
// cp_wait and a block-wide __syncthreads a stage for two k16 steps a
// warp, 64 x 64 tiles, dout split again by every warp and every channel
// tile): the K loop's exposed latency, not the tensor cores nor the
// split. On an H100 (700 W) the MMAs removed, its GEMM kept 73-81% of
// its device time at the four published shapes, the split removed 89-98%.
// What bounds this form: the gathers from L2, each hit's feature row and
// f32 dout row once a block (384 bytes a hit at 64 -> 64, 12 KB at 512 ->
// 512 over its 16 128 x 128 tiles), at ~2 TB/s, the dout rows two thirds
// of the bytes and most of the time: on an H100 (700 W), with the dout
// copies removed the 64 -> 64 GEMM fell by ~45%, with the feature rows'
// or the MMAs removed by nothing; 1-3 stages in flight, persistent
// blocks and L2 eviction hints moved nothing either.
// Design: 64-hit stages four deep behind full/empty mbarriers; a producer
// warpgroup gathers by cp.async (three stages in flight a thread), splits
// the dout rows in place once a stage for the whole block; consumer
// warpgroups issue wgmma m64n64k16 with A and B both MN-major from shared
// memory; 128 x 128 tiles where both widths exceed 64 halve each hit's
// gathers; the offsets launch centre first, so the largest blocks do not
// trail in the last wave; the stem's 8 channels take a dense form (dout
// read once for all 27 offsets, no rulebook).

constexpr int DW_BK = 64;      // hits a stage: K of four k16 steps
constexpr int DW_STAGES = 4;   // ring depth
constexpr int DW_LAG = 3;      // stages a producer keeps in flight: it
                               // splits a stage's dout DW_LAG stages on
constexpr int DW_BOX = 2 * BOX_BYTES;  // a 64-column dout box: hi, lo

// A block: MT consumer warpgroups, one per 64 dW rows (input channels),
// each over NB 64-column boxes (output channels), then the producers
template <int MT>
__host__ __device__ constexpr int dw_threads() {
  return 128 * MT + PT;
}

template <int MT, int NB>
__host__ __device__ constexpr int dw_ring_bytes() {
  return DW_STAGES * (MT * A_BYTES + NB * DW_BOX);
}

template <int MT, int NB>
inline size_t dw_smem_bytes() {
  return 1024 + dw_ring_bytes<MT, NB>() + 2 * DW_STAGES * 8;
}

// Whether the bf16 weight gradient takes its dense form: 8 channels (the
// stem's 3 padded), so one row's 27 neighbours are 27 16-byte copies and
// dW one (216, Co) matrix of four 64-row tiles over every row, dout read
// once for all offsets and no rulebook; else per offset over the rulebook.
__host__ __device__ inline bool dw_dense(int C) { return C == 8; }

// 8 f32 (x: columns 0-3, y: 4-7) -> their bf16 halves, hi = bf16_rn(v),
// lo = bf16_rn(v - hi), each as 8 bf16 in a row
__device__ __forceinline__ void split8(const float4& x, const float4& y,
                                       uint4& hi, uint4& lo) {
  const float v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 hh = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const __nv_bfloat162 ll = __floats2bfloat162_rn(
        v[2 * i] - __low2float(hh), v[2 * i + 1] - __high2float(hh));
    h[i] = *reinterpret_cast<const uint32_t*>(&hh);
    l[i] = *reinterpret_cast<const uint32_t*>(&ll);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// The offsets in launch order, grid z: the centre, the 6 faces, the 12
// edges, the 8 corners. In a scene the nearer offsets have more hits, so
// the largest blocks start first and the small ones fill the last wave
// (10% less time at 128 -> 128 and 64 -> 64 on an H100, 700 W, than in
// index order); the order does not change any block's bits.
__constant__ int DW_KORDER[KV] = {13, 4,  10, 12, 14, 16, 22, 1,  3,
                                  5,  7,  9,  11, 15, 17, 19, 21, 23,
                                  25, 0,  2,  6,  8,  18, 20, 24, 26};

// dW = sum over the hits (s, r) of feats[s]^T dout[r], f32 (splits, 27,
// C, Co), or each split's partial; feats bf16 (rows of C, C a multiple of
// 8), dout f32 (rows of Co, Co a multiple of 4, 16-byte aligned).
// - per offset (!DENSE): grid (C tiles x Co tiles, splits, 27); a block
//   owns a 64 MT x 64 NB tile of offset DW_KORDER[z]'s dW and walks the
//   split's rulebook segment (src, row, count of dw_rulebook_kernel), 64
//   hits a stage, the last stage's missing hits zero;
// - DENSE (dw_dense(C), MT 4, NB 1): grid (Co tiles, splits, 1); a block
//   walks the split's rows, 64 a stage, and gathers for each row its 27
//   neighbours' 8 channels (`map`; zero at a miss): dW row kk * 8 + c of
//   the (216, Co) matrix is channel c of offset kk.
// Stage j in ring slot j % DW_STAGES: the A tile(s), the 64 gathered
// feature rows (128 bytes a 64-channel tile) and, per 64-column box,
// dout's hi and lo halves of the 64 hits' rows, all stored hit by hit (K)
// in the 128-byte swizzle: both operands MN-major. Producer thread p
// copies 16-byte chunk q = p % 8 of rows p / 8 + 16 i of every tile by
// cp.async (one commit group a stage): 8 channels of a feature row, and
// of each dout row's box f32 columns 4q.. into the hi box's slot q and 32
// + 4q.. into the lo box's (so each copy instruction reads whole 128-byte
// halves of the rows). DW_LAG stages later it waits for that group,
// splits the rows into their bf16 halves in place, fences the
// generic-proxy writes for the async proxy
// and arrives on the stage's full mbarrier (no block-wide barrier),
// before it issues the next stage: the arrive's release then waits on no
// load issued since. Each stage's indices are read a stage ahead.
// Consumer warpgroup mt waits on full,
// issues per box the lo chain then the hi chain, four wgmma m64n64k16
// each (A and B MN-major), into a stage partial from 0, waits, arrives on
// empty and adds the partial to its f32 sum. A padding hit's rows are
// zero, so each dW entry is the f32 sum, in stage order, of its stage
// partials.
template <int MT, int NB, bool DENSE, class Map>
__global__ void __launch_bounds__(dw_threads<MT>(), MT * NB == 1 ? 2 : 1)
dw_bf16_kernel(const bf16* __restrict__ feats,
               const float* __restrict__ dout, Map map,
               const int* __restrict__ src, const int* __restrict__ row,
               const int* __restrict__ count, float* __restrict__ dw,
               int rows, int C, int Co, int rows_per_split) {
  static_assert(!DENSE || (MT == 4 && NB == 1), "dense: 4 x 64 dW rows");
  constexpr int CT = 128 * MT;  // consumer threads
  constexpr int STAGE_A = MT * A_BYTES, STAGE_B = NB * DW_BOX;
  constexpr int RPT = DW_BK / (PT / 8);  // rows a producer thread copies
  extern __shared__ uint8_t dw16_smem[];
  uint8_t* base =
      (uint8_t*)(((uintptr_t)dw16_smem + 1023) & ~(uintptr_t)1023);
  const uint32_t a_ring = smem_u32(base);
  const uint32_t b_ring = a_ring + DW_STAGES * STAGE_A;
  const uint32_t full = smem_u32(base + dw_ring_bytes<MT, NB>());
  const uint32_t empty = full + DW_STAGES * 8;

  const int tid = threadIdx.x;
  const int n_otiles = (Co + 64 * NB - 1) / (64 * NB);
  const int o0 = (blockIdx.x % n_otiles) * 64 * NB;
  const int c0 = DENSE ? 0 : (blockIdx.x / n_otiles) * 64 * MT;
  const int k = DENSE ? 0 : DW_KORDER[blockIdx.z];
  const int split = blockIdx.y, splits = gridDim.y;
  const int r_begin = split * rows_per_split;
  const size_t seg = ((size_t)k * splits + split) * rows_per_split;
  // this block's entries: its rows (dense) or its offset's hits
  const int n = DENSE ? max(0, min(rows, r_begin + rows_per_split) - r_begin)
                      : count[k * splits + split];
  const int nst = (n + DW_BK - 1) / DW_BK;

  if (tid == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(full + 8 * s, PT);
      mbar_init(empty + 8 * s, CT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CT) {
    const int p = tid - CT, q = p & 7;
    // a stage's sources of this thread's rows e = p / 8 + 16 i: per
    // offset the input row (src) and the dout row; dense the raw map
    // entries of offsets 8 t + q, the dout row and the row's base (one
    // division a row, the map's row_entry / row_base)
    constexpr int NI = DENSE ? MT : 1;
    int nxt_s[RPT][NI], nxt_r[RPT], nxt_b[RPT];
    auto load_idx = [&](int j) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int e = j * DW_BK + (p >> 3) + 16 * i;
        const bool ok = e < n;
        if constexpr (DENSE) {
          const int r = r_begin + e;
          const int* ent = map.row_entry(ok ? r : 0);
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            const int kk = 8 * t + q;
            nxt_s[i][t] = ok && kk < KV ? ent[kk * map.kstride()] : -1;
          }
          nxt_r[i] = ok ? r : -1;
          nxt_b[i] = ok ? map.row_base(r) : 0;
        } else {
          nxt_s[i][0] = ok ? src[seg + e] : -1;
          nxt_r[i] = ok ? row[seg + e] : -1;
          nxt_b[i] = 0;
        }
      }
    };
    if (nst > 0) load_idx(0);
    for (int j = 0; j < nst + DW_LAG; ++j) {
      if (j >= DW_LAG) {
        // stage j - DW_LAG's copies (this thread's) landed: split the
        // dout rows into their bf16 halves in place. Thread q holds f32
        // columns 4q.. (in the hi box's slot q) and 32 + 4q.. (the lo
        // box's); with its neighbour q ^ 1 it forms 8 columns, column
        // chunk q / 2 (even q) or 4 + q / 2 (odd q), and writes their hi
        // and lo chunks. A row's 256 bytes are its 8 threads' (one warp):
        // every thread reads before any writes.
        asm volatile("cp.async.wait_group %0;" ::"n"(DW_LAG - 1)
                     : "memory");
        const int slot = (j - DW_LAG) % DW_STAGES;
        uint8_t* bb = base + DW_STAGES * STAGE_A + slot * STAGE_B;
        const int cc = (q >> 1) + 4 * (q & 1);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int e = (p >> 3) + 16 * i;
          const int off = e * 128 + ((q ^ (e & 7)) << 4);
          const int dst = e * 128 + ((cc ^ (e & 7)) << 4);
          float4 x[NB], y[NB];
#pragma unroll
          for (int h = 0; h < NB; ++h) {
            x[h] = *reinterpret_cast<float4*>(bb + h * DW_BOX + off);
            y[h] = *reinterpret_cast<float4*>(bb + h * DW_BOX + BOX_BYTES +
                                              off);
          }
          __syncwarp();
#pragma unroll
          for (int h = 0; h < NB; ++h) {
            const float4 send = q & 1 ? x[h] : y[h];
            float4 got;
            got.x = __shfl_xor_sync(0xffffffffu, send.x, 1);
            got.y = __shfl_xor_sync(0xffffffffu, send.y, 1);
            got.z = __shfl_xor_sync(0xffffffffu, send.z, 1);
            got.w = __shfl_xor_sync(0xffffffffu, send.w, 1);
            uint4 hi, lo;
            if (q & 1)
              split8(got, y[h], hi, lo);
            else
              split8(x[h], got, hi, lo);
            *reinterpret_cast<uint4*>(bb + h * DW_BOX + dst) = hi;
            *reinterpret_cast<uint4*>(bb + h * DW_BOX + BOX_BYTES + dst) = lo;
          }
        }
        // the halves (generic proxy) are read by wgmma (async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(full + 8 * slot);
      }
      if (j < nst) {
        int cur_s[RPT][NI], cur_r[RPT], cur_b[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          cur_r[i] = nxt_r[i];
          cur_b[i] = nxt_b[i];
#pragma unroll
          for (int t = 0; t < NI; ++t) cur_s[i][t] = nxt_s[i][t];
        }
        if (j + 1 < nst) load_idx(j + 1);  // read a stage ahead
        const int slot = j % DW_STAGES;
        if (j >= DW_STAGES)
          mbar_wait(empty + 8 * slot, ((j / DW_STAGES) - 1) & 1);
        const uint32_t a = a_ring + slot * STAGE_A;
        const uint32_t b = b_ring + slot * STAGE_B;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int e = (p >> 3) + 16 * i;
          const uint32_t off = e * 128 + ((q ^ (e & 7)) << 4);
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            const int s = DENSE ? map.resolve_at(cur_s[i][t], cur_b[i])
                                : cur_s[i][0];
            const int c = DENSE ? 0 : c0 + 64 * t + 8 * q;
            const bool ok = s >= 0 && c < C;
            cp_async16(a + t * A_BYTES + off,
                       ok ? feats + (size_t)s * C + c : feats, ok);
          }
          // dout: f32 columns 4q.. into the hi box's slot q, 32 + 4q..
          // into the lo box's (each copy of the 8 threads a contiguous
          // 128 bytes), split in place DW_LAG stages later
          const int r = cur_r[i];
#pragma unroll
          for (int h = 0; h < NB; ++h) {
            const int o = o0 + 64 * h + 4 * q;
            const float* d = dout + (size_t)(r >= 0 ? r : 0) * Co + o;
            cp_async16(b + h * DW_BOX + off, r >= 0 && o < Co ? d : dout,
                       r >= 0 && o < Co);
            cp_async16(b + h * DW_BOX + BOX_BYTES + off,
                       r >= 0 && o + 32 < Co ? d + 32 : dout,
                       r >= 0 && o + 32 < Co);
          }
        }
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // consumer warpgroup mt: dW rows 64 mt.. of the tile, every box
  const int warp = tid >> 5, lane = tid & 31, mt = warp >> 2;
  float acc[NB][32], part[NB][32];
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[h][e] = part[h][e] = 0.f;
  for (int j = 0; j < nst; ++j) {
    const int slot = j % DW_STAGES;
    mbar_wait(full + 8 * slot, (j / DW_STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint32_t a = a_ring + slot * STAGE_A + mt * A_BYTES;
    const uint32_t b = b_ring + slot * STAGE_B;
#pragma unroll
    for (int h = 0; h < NB; ++h) fence_regs(part[h]);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      // the low half's chain, then the high half's, from 0; A and B
      // MN-major: 8-row K groups 1024 bytes apart, k16 steps 2 KB down
#pragma unroll
      for (int half = 1; half >= 0; --half)
#pragma unroll
        for (int s = 0; s < DW_BK / 16; ++s)
          wgmma64<1>(part[h], desc_sw128(a + 2048 * s, A_BYTES, 1024),
                     desc_sw128(b + h * DW_BOX + half * BOX_BYTES + 2048 * s,
                                BOX_BYTES, 1024),
                     half == 0 || s > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int h = 0; h < NB; ++h) fence_regs(part[h]);
    mbar_arrive(empty + 8 * slot);
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[h][e] += part[h][e];
  }

  // acc[h][4 jj + 2 hh + x]: dW row 16 (warp % 4) + g + 8 hh of the
  // warpgroup's 64, column 64 h + 8 jj + 2 t + x (g = lane / 4, t = lane
  // % 4); dense: the (216, Co) matrix's row, i.e. offset row / 8, channel
  // row % 8
  const int g = lane >> 2, t4 = lane & 3;
  const int m_lim = DENSE ? KV * C : C - c0;
  float* out = dw + ((size_t)split * KV + k) * C * Co;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = 64 * mt + 16 * (warp & 3) + g + 8 * hh;
    if (m >= m_lim) continue;
    float* o = out + (size_t)(c0 + m) * Co;
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = o0 + 64 * h + 8 * jj + 2 * t4;
        if (col < Co)  // Co is even: col + 1 < Co too
          *reinterpret_cast<float2*>(o + col) = make_float2(
              acc[h][4 * jj + 2 * hh], acc[h][4 * jj + 2 * hh + 1]);
      }
  }
}

// --- host side ---

// cuTensorMapEncodeTiled, a libcuda entry point, found through the CUDA
// runtime's entry-point query (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// the (27 C, Co) bf16 weights as a tensor map of 64 x 64 boxes, 128-byte
// swizzle, zeros outside; Co a multiple of 8 and w 16-byte aligned
inline cudaError_t weight_map(const void* w, int C, int Co, CUtensorMap* map) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)Co, (cuuint64_t)KV * C};
  const cuuint64_t strides[1] = {(cuuint64_t)Co * 2};
  const cuuint32_t box[2] = {64, BK};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(w), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The live-stage list's capacity of a launch: the most stages a split has
inline int live_cap(int C, int splits) {
  int most = 0;
  for (int s = 0; s < splits; ++s) {
    const int nk = (s + 1) * KV / splits - s * KV / splits;
    most = num_stages(nk, C) > most ? num_stages(nk, C) : most;
  }
  return most;
}

// Launch `kernel` (a conv kernel over conv_tile_sm90<MT, NB>) with its
// dynamic shared memory; the error of the attribute call or of the launch.
template <int MT, int NB, typename Kernel, typename... Args>
cudaError_t launch_sm90(Kernel kernel, dim3 grid, int cap, cudaStream_t st,
                        Args... args) {
  const size_t smem = smem_bytes<MT, NB>(cap);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads<MT, NB>(), smem, st>>>(args...);
  return cudaGetLastError();
}

// Launch dw_bf16_kernel<MT, NB, DENSE> into dst with its dynamic shared
// memory; the error of the attribute call or of the launch.
template <int MT, int NB, bool DENSE, class Map>
cudaError_t launch_dw_tile(const bf16* feats, const float* dout, Map map,
                           const int* src, const int* row, const int* count,
                           float* dst, int rows, int C, int Co, int splits,
                           int rows_per_split, cudaStream_t st) {
  auto kernel = dw_bf16_kernel<MT, NB, DENSE, Map>;
  const size_t smem = dw_smem_bytes<MT, NB>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int otiles = (Co + 64 * NB - 1) / (64 * NB);
  const int ctiles = DENSE ? 1 : (C + 64 * MT - 1) / (64 * MT);
  kernel<<<dim3(ctiles * otiles, splits, DENSE ? 1 : KV), dw_threads<MT>(),
           smem, st>>>(feats, dout, map, src, row, count, dst, rows, C, Co,
                       rows_per_split);
  return cudaGetLastError();
}

// The bf16 weight gradient's GEMM into dst ((splits, 27, C, Co)): dense
// where dw_dense(C) (the neighbours from `map`), else per offset over the
// rulebook (src, row, count); a dW tile is 128 x 128 where C and Co are
// both above 64 (two consumer warpgroups reading each dout box, each
// gathered feature row serving both boxes: half the gathers a hit), else
// 64 x 64, two blocks an SM (ops/sparse_conv_kernel.py:dw_tiles counts the
// same tiles).
template <class Map>
cudaError_t launch_dw_bf16(const bf16* feats, const float* dout, Map map,
                           const int* src, const int* row, const int* count,
                           float* dst, int rows, int C, int Co, int splits,
                           int rows_per_split, cudaStream_t st) {
#define SC90_DW(MT, NB, DENSE)                                              \
  launch_dw_tile<MT, NB, DENSE>(feats, dout, map, src, row, count, dst,     \
                                rows, C, Co, splits, rows_per_split, st)
  if (dw_dense(C)) return SC90_DW(4, 1, true);
  return C > 64 && Co > 64 ? SC90_DW(2, 2, false) : SC90_DW(1, 1, false);
#undef SC90_DW
}

}  // namespace sparse_conv_sm90
