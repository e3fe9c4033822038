// Kernel N: the greedy same-class 3D NMS of the eval step (Hopper), as an
// overlap bitmask built in parallel over the card and a short scan of its
// words, one warp a scene.
//
// Not the port of a TPU kernel: the JAX eval step computes this function
// in XLA, outside Pallas, as a `jax.lax.while_loop` of masked argmax and
// suppress (vdetr_tpu/geometry/nms.py:nms_3d_samecls_mask, called from
// vdetr_tpu/train/engine.py:_build_eval_step). Eager PyTorch would pay
// ~5 launches per step of that loop, ~5k per scene; this is two launches.
//
// Function: keep[b, k] = box k of scene b is picked by the greedy loop
// that repeatedly takes the alive box of the largest score (the lowest
// index among equal scores), keeps it, and kills every alive box of its
// class whose axis-aligned overlap with it is > thr; `valid` seeds alive.
// The wrapper (geometry/nms.py) passes the boxes' order of a stable
// descending sort of the scores, and everything below works on positions
// in that order. The box the loop picks next is the first alive box of the
// order, so a box is kept exactly when no box kept before it in the order
// kills it; a box kills only boxes after it, never itself
// (tests/test_torch_kernel_premises.py holds this form to the loop).
//
// The overlap is JAX's f32 formula in JAX's order, every operation
// rounded on its own (the _rn intrinsics: no fused multiply-add), so a
// pair exactly at the threshold goes the same way as in the plain loop:
//   inter = (max(xx2-xx1,0) * max(yy2-yy1,0)) * max(zz2-zz1,0)
//   ov    = inter / max((area_i + area_j) - inter, 1e-12)
//   (old_type: inter / max(area_j, 1e-12)), area = ((x2-x1)*(y2-y1))*(z2-z1)
// with i the kept (earlier) box and j the box tested, and the predicate
// (cls_j == cls_i ? ov : 0) > thr as JAX writes it (it differs from
// `same && ov > thr` when thr < 0). Inputs are finite.
//
// Design, two launches on the caller's stream:
// 1. nms_mask_kernel, grid (column tile, row tile, scene), the upper
//    triangle only (column tile >= row tile), 256 threads. The block
//    stages its column tile's 64 boxes (AABB, area, class) in shared
//    memory; four neighbouring lanes take the row box at position
//    64 * row tile + r, 16 columns each, and their bits are ORed by
//    shuffles into one 64-bit word of mask (B, K, W), W = ceil(K / 64):
//    bit j is set when the row box kills the box at position
//    64 * column tile + j, for positions after the row's own. The
//    diagonal blocks also write their tile's seed word of the removed
//    set: bit j set when the box at that position is not valid or the
//    position is past K.
// 2. nms_scan_kernel, one warp a scene. The removed set is W words in
//    shared memory, loaded from the seed words. For each row tile in
//    order, each lane first issues the loads of its two rows' words for
//    the next 16 words; then the warp resolves the tile's 64 boxes
//    against their diagonal words while those loads are in flight: a box
//    not removed when reached is kept, and the boxes its word marks are
//    removed. The warp reaches that set as the fixed point of a few
//    rounds of one warp OR each (`redux.sync`), and walks the tile in
//    order, a bit test a box, where 4 rounds do not settle it. Then each
//    lane masks its rows by the kept bits and the warp ORs each later
//    word together into the removed set.
//    The next tile's diagonal words are loaded a tile ahead. The kept
//    positions go back through `order` into `keep`.
// What bounds each launch: the mask launch, its K^2/2 overlap tests of
// ~20 flops and the upper triangle's words it writes (8 * 64 * W(W+1)/2
// bytes: 70 KB a scene at K = 1024, 16 MB at 16384, which stays in the
// 50 MB L2 for the scan); the scan, its dependent steps: per tile a few
// warp ORs (or at most 64 bit tests) and the later words' ORs, with about
// one L2 round trip a tile that the tile's own resolution mostly hides,
// where the barrier scan it replaces paid K block-wide barriers (~355 ns
// each). No step waits on a barrier per box: every pair's outcome is in
// the mask before the scan starts, so what is left in order is a
// resolution per 64-box tile in one warp's registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int TILE = 64;
constexpr int MAX_BOXES = 16 * 1024;  // geometry/nms.py:NMS_MAX_BOXES
constexpr int MAX_WORDS = MAX_BOXES / TILE;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SPLIT = 4;   // mask kernel: lanes a row
constexpr int AHEAD = 16;  // scan kernel: later words a lane loads ahead
constexpr int ROUNDS = 4;  // scan kernel: warp rounds before a tile's walk

struct Box {
  float x1, y1, z1, x2, y2, z2, area;
  int cls;
};

__device__ __forceinline__ Box load_box(const float* aabbs,
                                        const int* classes, int k) {
  const float* a = aabbs + (size_t)k * 6;
  Box r{a[0], a[1], a[2], a[3], a[4], a[5], 0.f, classes[k]};
  r.area = __fmul_rn(__fmul_rn(__fsub_rn(r.x2, r.x1), __fsub_rn(r.y2, r.y1)),
                     __fsub_rn(r.z2, r.z1));
  return r;
}

// does kept box i kill box j: JAX's overlap and predicate, in JAX's order
__device__ __forceinline__ bool kills(const Box& i, const Box& j, float thr,
                                      bool old_type) {
  const float dx = fmaxf(__fsub_rn(fminf(i.x2, j.x2), fmaxf(i.x1, j.x1)), 0.f);
  const float dy = fmaxf(__fsub_rn(fminf(i.y2, j.y2), fmaxf(i.y1, j.y1)), 0.f);
  const float dz = fmaxf(__fsub_rn(fminf(i.z2, j.z2), fmaxf(i.z1, j.z1)), 0.f);
  const float inter = __fmul_rn(__fmul_rn(dx, dy), dz);
  const float denom =
      old_type ? j.area : __fsub_rn(__fadd_rn(i.area, j.area), inter);
  const float ov = __fdiv_rn(inter, fmaxf(denom, 1e-12f));
  return (j.cls == i.cls ? ov : 0.f) > thr;
}

__global__ void __launch_bounds__(TILE * SPLIT)
nms_mask_kernel(const float* __restrict__ aabbs,
                const int* __restrict__ order,
                const int* __restrict__ classes,
                const uint8_t* __restrict__ valid, u64* __restrict__ mask,
                u64* __restrict__ seed, int K, int W, float thr,
                int old_type) {
  const int ct = blockIdx.x, rt = blockIdx.y, tid = threadIdx.x;
  if (ct < rt) return;  // the lower triangle: never read
  const size_t b = blockIdx.z;
  aabbs += b * K * 6;
  order += b * K;
  classes += b * K;
  valid += b * K;
  mask += b * K * W;
  __shared__ Box col[TILE];

  if (tid < TILE) {  // warps 0 and 1 stage the column tile
    const int cp = ct * TILE + tid;
    if (cp < K) col[tid] = load_box(aabbs, classes, order[cp]);
    if (ct == rt) {  // the tile's seed word, 32 bits a warp
      const unsigned bits =
          __ballot_sync(FULL, cp >= K || !valid[order[cp]]);
      if ((tid & 31) == 0)
        reinterpret_cast<unsigned*>(seed + b * W + ct)[tid >> 5] = bits;
    }
  }
  __syncthreads();

  // SPLIT neighbouring lanes share a row, each taking TILE / SPLIT columns
  const int r = tid / SPLIT, q = tid % SPLIT;
  const int rp = rt * TILE + r;
  const int n = min(TILE, K - ct * TILE);
  u64 word = 0;
  if (rp < K) {
    const Box row = ct == rt ? col[r] : load_box(aabbs, classes, order[rp]);
    const int lo = q * (TILE / SPLIT);
    const int hi = min(lo + TILE / SPLIT, n);
    for (int j = ct == rt ? max(lo, r + 1) : lo; j < hi; ++j)
      if (kills(row, col[j], thr, old_type != 0)) word |= 1ull << j;
  }
#pragma unroll
  for (int off = 1; off < SPLIT; off *= 2)
    word |= __shfl_xor_sync(FULL, word, off);
  if (rp < K && q == 0) mask[(size_t)rp * W + ct] = word;
}

// the OR of x over the warp, in every lane
__device__ __forceinline__ u64 warp_or(u64 x) {
  return (u64)__reduce_or_sync(FULL, (unsigned)(x >> 32)) << 32 |
         __reduce_or_sync(FULL, (unsigned)x);
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const u64* __restrict__ mask, const u64* __restrict__ seed,
                const int* __restrict__ order, uint8_t* __restrict__ keep,
                int K, int W) {
  __shared__ u64 removed[MAX_WORDS];
  __shared__ u64 diag[TILE];
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x;
  mask += b * K * W;
  seed += b * W;
  order += b * K;
  keep += b * K;
  for (int w = lane; w < W; w += 32) removed[w] = seed[w];

  // tile t's diagonal words and boxes, positions 64 t + lane and + 32
  u64 d0, d1;
  int o0, o1;
  auto fetch = [&](int t, u64& e0, u64& e1, int& p0, int& p1) {
    const int r0 = t * TILE + lane, r1 = r0 + 32;
    e0 = r0 < K ? mask[(size_t)r0 * W + t] : 0;
    e1 = r1 < K ? mask[(size_t)r1 * W + t] : 0;
    p0 = r0 < K ? order[r0] : -1;
    p1 = r1 < K ? order[r1] : -1;
  };
  fetch(0, d0, d1, o0, o1);

  for (int t = 0; t < W; ++t) {
    const int r0 = t * TILE + lane, r1 = r0 + 32;
    const u64* row0 = mask + (size_t)r0 * W;
    const u64* row1 = mask + (size_t)r1 * W;
    // the lane's two rows' words for the next AHEAD words, in flight
    // while the tile is resolved
    u64 w0[AHEAD], w1[AHEAD];
#pragma unroll
    for (int c = 0; c < AHEAD; ++c) {
      const int u = t + 1 + c;
      w0[c] = u < W && r0 < K ? row0[u] : 0;
      w1[c] = u < W && r1 < K ? row1[u] : 0;
    }
    u64 n0 = 0, n1 = 0;
    int q0 = -1, q1 = -1;
    if (t + 1 < W) fetch(t + 1, n0, n1, q0, q1);
    diag[lane] = d0;
    diag[lane + 32] = d1;
    __syncwarp();

    // the tile's 64 boxes: the kept set is the fixed point of kept =
    // alive & ~(the bits of the kept rows' diagonal words). It is unique
    // (a box kills only boxes after it, so box i's fate follows from the
    // boxes before it) and it is what the walk in order keeps. Each round
    // of the iteration from kept = alive is one warp OR and settles at
    // least the next box; a round that changes nothing has reached it. A
    // tile not settled in ROUNDS rounds is walked in order, a bit test a
    // box, every lane the same.
    const u64 cur = removed[t], alive = ~cur;
    u64 kept = alive;
    bool settled = false;
#pragma unroll 1
    for (int round = 0; round < ROUNDS && !settled; ++round) {
      const u64 x = ((kept >> lane) & 1 ? d0 : 0) |
                    ((kept >> (lane + 32)) & 1 ? d1 : 0);
      const u64 next = alive & ~warp_or(x);
      settled = next == kept;
      kept = next;
    }
    if (!settled) {
      u64 gone = cur;
      kept = 0;
#pragma unroll
      for (int i = 0; i < TILE; ++i) {
        const u64 w = diag[i];
        if (!((gone >> i) & 1)) {
          kept |= 1ull << i;
          gone |= w;
        }
      }
    }
    if (o0 >= 0) keep[o0] = (kept >> lane) & 1;
    if (o1 >= 0) keep[o1] = (kept >> (lane + 32)) & 1;

    // OR the kept rows' words into the later words: each lane masks its
    // two rows, the warp reduces each word
    const u64 m0 = (kept >> lane) & 1 ? ~0ull : 0ull;
    const u64 m1 = (kept >> (lane + 32)) & 1 ? ~0ull : 0ull;
    for (int u0 = t + 1; u0 < W; u0 += AHEAD) {
      if (u0 > t + 1) {  // past the words fetched ahead: kept rows only
#pragma unroll
        for (int c = 0; c < AHEAD; ++c) {
          const int u = u0 + c;
          w0[c] = u < W && m0 ? row0[u] : 0;
          w1[c] = u < W && m1 ? row1[u] : 0;
        }
      }
#pragma unroll
      for (int c = 0; c < AHEAD; ++c) {
        const int u = u0 + c;
        if (u < W) {
          const u64 x = warp_or((w0[c] & m0) | (w1[c] & m1));
          if (lane == 0) removed[u] |= x;
        }
      }
    }
    __syncwarp();
    d0 = n0;
    d1 = n1;
    o0 = q0;
    o1 = q1;
  }
}

}  // namespace

// keep (B, K) bytes 0/1 = the greedy same-class NMS of each scene.
// aabbs (B, K, 6) f32 (x1, y1, z1, x2, y2, z2); order (B, K) int32, each
// row the boxes in the order of a stable descending sort of the scores;
// classes (B, K) int32; valid (B, K) bytes 0/1; words: scratch of
// B * (K + 1) * ceil(K / 64) 64-bit words (the mask, then the seed
// words). K <= 16 * 1024.
extern "C" int nms_samecls_f32(const void* aabbs, const void* order,
                               const void* classes, const void* valid,
                               void* words, void* keep, int B, int K,
                               float thr, int old_type, void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaGetLastError();
  if (K > MAX_BOXES || B > 65535) return (int)cudaErrorInvalidValue;
  const int W = (K + TILE - 1) / TILE;
  auto* mask = (u64*)words;
  u64* seed = mask + (size_t)B * K * W;
  auto st = (cudaStream_t)stream;
  nms_mask_kernel<<<dim3(W, W, B), TILE * SPLIT, 0, st>>>(
      (const float*)aabbs, (const int*)order, (const int*)classes,
      (const uint8_t*)valid, mask, seed, K, W, thr, old_type);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<B, 32, 0, st>>>(mask, seed, (const int*)order,
                                    (uint8_t*)keep, K, W);
  return (int)cudaGetLastError();
}
