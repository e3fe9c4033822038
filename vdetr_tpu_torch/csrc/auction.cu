// Kernel M: the matcher's auction assignment (Hopper), every bidding round
// of every problem of a batch in one launch, one block a problem.
//
// Not the port of a TPU kernel: the JAX train step computes this function
// in XLA, outside Pallas, as the `jax.lax.while_loop`s of
// vdetr_tpu/ops/hungarian.py:_auction_single (the plain auction) and
// :_auction_capacity_single (the capacity auction over the repeat-tiled
// GT rows), vmapped over the batch. Eager PyTorch would pay a host sync a
// round for the loop's condition; here the host never reads a round.
//
// Function, per problem p (cost rows r < n, columns j < m, f32, minimize):
//   eps = eps_frac * max(spread, 1e-3), spread = max - min of -cost over
//   the genuine entries (valid rows, cost < 1e5), 1 where none is genuine.
// repeat == 1 (plain): while a valid row (r < n_valid) is unassigned and
//   rounds < max_iters: every unassigned row takes its best net value
//   v1 = -cost[r, j1] - price[j1] (the first column among equal values)
//   and the second best v2 (v1 - eps when m == 1), and bids
//   price[j1] + (v1 - v2) + eps; each column bid on goes to its highest
//   bid (the lowest row among equal bids) at that price, and the row that
//   held it is evicted.
// repeat > 1 (capacity): class c < g = n_valid / repeat owns up to
//   `repeat` columns; its values are row c. While a class owns fewer and
//   rounds < max_iters: each such class takes its top need + 1 net values
//   in lax.top_k's order (larger first, +0 above -0, the lower column
//   among equal values; the columns it owns at -1e30) and bids
//   price[j] + (v_s - v_need) + eps on its top `need` (where both are
//   above -5e29); each column bid on goes to its highest bid (the lowest
//   class among equal bids). Then the columns of class c go, in ascending
//   column order, to its copies c, c + g, ..., c + (repeat-1) g.
// Output col4row (P, n) int32 (-1 for rows past n_valid and rows left
// unassigned), and the rounds each problem ran.
//
// Bit for bit with the plain versions (ops/hungarian.py) and JAX: every
// f32 operation is the JAX one in its order, rounded on its own
// (__fsub_rn/__fadd_rn/__fmul_rn: nvcc contracts nothing). The spread's
// max and min are exact in any order. The bids of a round meet in a shared
// 64-bit atomicMax per column whose key is the bid's order-preserving bits
// above (0xffffffff - bidder): the highest bid, then the lowest bidder, as
// JAX's scatter-max and scatter-min give them, in any order of arrival.
// Bids are >= the column's price >= 0, so no -0 meets +0.
//
// Design: 1024 threads a block. Shared memory holds the problem's state:
// per column the best bid's key, the price and the owner (row or class);
// per row the held column (plain) or per class the columns owned
// (capacity). A round has two block barriers: each warp takes rows r =
// warp, warp + 32, ... and bids for those still unfinished; a block-wide OR
// of "some row or class is unfinished" ends the loop where none is (the
// loop's condition) and is the barrier after the bids; a thread a column
// then settles them, and a barrier ends the round.
//
// A row's top entries: an entry (v, j) is the order-preserving bits of v
// and its column, compared as top_k orders them (the larger value, then the
// lower column; the plain auction takes -0 as +0, as its argmax does). One
// pass over the row: each lane keeps the top two entries of its columns (j
// = lane, lane + 32, ...) in registers. Then need + 1 pops (2 in the plain
// auction), each two redux.sync over the lanes' heads (the largest bits,
// then the lowest column with them); the lane that held the entry moves its
// second one up, and a lane emptied while pops remain refills its top two
// among its entries after the last it gave (rare: the row's top need + 1
// seldom fall three to one lane). Lane s keeps entry s; lanes s < need post
// their bids. A pop is a merge of sorted lists, so the entries are those
// that need + 1 warp-wide arg-max passes over the row, each after the last,
// would take. The plain auction's decoded value is +0 where the row's was
// -0: its bid price + (v1 - v2) + eps is the same for both (prices are >=
// +0).
//
// What bounds it: its rounds, each a pass of a warp over each bidding row's
// columns (one cost read, a price read and ~15 instructions a column: the
// SM's instruction throughput, one problem to an SM), the pops, and the
// latency of the round's chain (the pass, the pops, the bids' shared
// atomics, a barrier, the settling, a barrier); the bytes (the valid rows
// read once) and the compares (rounds x rows x columns) are far below.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;       // JAX's sentinel for owned columns
constexpr float HALF_NEG = NEG / 2;  // as JAX's neg / 2

__device__ __forceinline__ unsigned order_bits(float x) {
  unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// An entry (v, j) is the order-preserving bits of v and the column j:
// (v, j) comes first when its bits are larger, or equal and j lower, as
// in lax.top_k, where +0 is above -0 (CAPACITY); the plain auction's
// argmax takes -0 and +0 as equal (v + 0 is +0 for both). An empty slot
// is (0, INT_MAX): 0 is below the bits of every value.
template <bool CAPACITY>
__device__ __forceinline__ unsigned value_bits(float v) {
  return order_bits(CAPACITY ? v : __fadd_rn(v, 0.0f));
}

__device__ __forceinline__ float bits_value(unsigned x) {
  return x ? from_order_bits(x) : -INFINITY;
}

// The lane's top two entries over its columns j = lane, lane + 32, ...
// (BELOW: among those after (bx, bj)): the net value -cost - price, or
// NEG where the class owns the column (CAPACITY). The lane's columns
// ascend, so an entry equal to a kept one comes after it.
template <bool CAPACITY, bool BELOW>
__device__ __forceinline__ void lane_top2(const float* row,
                                          const float* price,
                                          const int* owner, int cls, int m,
                                          int lane, unsigned bx, int bj,
                                          unsigned& x0, int& j0,
                                          unsigned& x1, int& j1) {
  x0 = x1 = 0u;
  j0 = j1 = 0x7fffffff;
#pragma unroll 4
  for (int j = lane; j < m; j += 32) {
    const float c = __ldg(row + j);
    const float v = CAPACITY && owner[j] == cls ? NEG
                                                : __fsub_rn(-c, price[j]);
    const unsigned x = value_bits<CAPACITY>(v);
    if (BELOW && !(x < bx || (x == bx && j > bj))) continue;
    if (x > x0) {
      x1 = x0;
      j1 = j0;
      x0 = x;
      j0 = j;
    } else if (x > x1) {
      x1 = x;
      j1 = j;
    }
  }
}

// The row's top `take` entries in top_k's order: every lane returns the
// last (cut_x, cut_j), lane s < take entry s (mine_x, mine_j). A pop is
// two redux.sync: the largest head's bits, then the lowest column among
// the heads with those bits.
template <bool CAPACITY>
__device__ __forceinline__ void row_top(const float* row, const float* price,
                                        const int* owner, int cls, int m,
                                        int lane, int take, unsigned& mine_x,
                                        int& mine_j, unsigned& cut_x,
                                        int& cut_j) {
  unsigned x0, x1;
  int j0, j1;
  lane_top2<CAPACITY, false>(row, price, owner, cls, m, lane, 0u, 0, x0, j0,
                             x1, j1);
  mine_x = cut_x = 0u;
  mine_j = cut_j = 0x7fffffff;
  for (int s = 0; s < take; ++s) {
    const unsigned mx = __reduce_max_sync(FULL, x0);
    const int mj = (int)__reduce_min_sync(
        FULL, x0 == mx ? (unsigned)j0 : 0xffffffffu);
    if (lane == s) {
      mine_x = mx;
      mine_j = mj;
    }
    cut_x = mx;
    cut_j = mj;
    if (mx != 0u && x0 == mx && j0 == mj) {  // this lane's head
      x0 = x1;
      j0 = j1;
      x1 = 0u;
      j1 = 0x7fffffff;
      if (x0 == 0u && s + 1 < take)
        lane_top2<CAPACITY, true>(row, price, owner, cls, m, lane, mx, mj,
                                  x0, j0, x1, j1);
    }
  }
}

__device__ __forceinline__ void post_bid(u64* best, int j, float bid,
                                         int bidder) {
  const u64 key = ((u64)order_bits(bid) << 32) |
                  (u64)(0xffffffffu - (unsigned)bidder);
  atomicMax(best + j, key);
}

__global__ void __launch_bounds__(THREADS)
auction_kernel(const float* __restrict__ cost, const int* __restrict__ nvalid,
               int* __restrict__ col4row_out, int* __restrict__ rounds_out,
               int n, int m, int repeat, float eps_frac, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* best = reinterpret_cast<u64*>(smem);
  float* price = reinterpret_cast<float*>(best + m);
  int* owner = reinterpret_cast<int*>(price + m);
  int* rowstate = owner + m;  // plain: col4row[n]; capacity: count[g_max]
  __shared__ float red_max[WARPS], red_min[WARPS];
  __shared__ float eps_s;

  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* C = cost + (size_t)p * n * m;
  int* out = col4row_out + (size_t)p * n;
  const int nv = nvalid[p];
  const bool capacity = repeat > 1;
  const int rows = capacity ? n / repeat : n;    // value rows read
  const int live = capacity ? nv / repeat : nv;  // valid classes or rows

  for (int j = tid; j < m; j += THREADS) {
    best[j] = 0ull;  // below every key of a finite bid
    price[j] = 0.f;
    owner[j] = -1;
  }
  for (int r = tid; r < rows; r += THREADS) rowstate[r] = capacity ? 0 : -1;

  // eps from the genuine entries: max and min are exact in any order
  float vmax = -INFINITY, vmin = INFINITY;
  const int lrows = live < rows ? live : rows;
  for (int r = warp; r < lrows; r += WARPS) {
    const float* row = C + (size_t)r * m;
    for (int j = lane; j < m; j += 32) {
      const float c = __ldg(row + j);
      if (c < 1e5f) {
        vmax = fmaxf(vmax, -c);
        vmin = fminf(vmin, -c);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    vmax = fmaxf(vmax, __shfl_xor_sync(FULL, vmax, off));
    vmin = fminf(vmin, __shfl_xor_sync(FULL, vmin, off));
  }
  if (lane == 0) {
    red_max[warp] = vmax;
    red_min[warp] = vmin;
  }
  __syncthreads();
  if (tid == 0) {
    float a = -INFINITY, b = INFINITY;
    for (int w = 0; w < WARPS; ++w) {
      a = fmaxf(a, red_max[w]);
      b = fminf(b, red_min[w]);
    }
    float spread = __fsub_rn(a, b);
    if (!isfinite(spread)) spread = 1.0f;
    spread = fmaxf(spread, 1e-3f);
    eps_s = __fmul_rn(eps_frac, spread);
  }
  __syncthreads();
  const float eps = eps_s;

  int it = 0;
  while (it < max_iters) {
    // bids of the rows or classes still short of their columns: the
    // unfinished ones (the loop's condition)
    int unfinished = 0;
    for (int r = warp; r < lrows; r += WARPS) {
      const float* row = C + (size_t)r * m;
      if (capacity) {
        const int need = repeat - rowstate[r];
        if (need <= 0) continue;
        unfinished = 1;
        unsigned mine_x, cut_x;
        int mine_j, cut_j;
        row_top<true>(row, price, owner, r, m, lane, need + 1, mine_x, mine_j,
                      cut_x, cut_j);
        const float mine_v = bits_value(mine_x);
        const float vcut = bits_value(cut_x);  // the (need+1)-th best
        if (lane < need && mine_v > HALF_NEG && vcut > HALF_NEG) {
          const float bid = __fadd_rn(
              __fadd_rn(price[mine_j], __fsub_rn(mine_v, vcut)), eps);
          post_bid(best, mine_j, bid, r);
        }
      } else {
        if (rowstate[r] >= 0) continue;
        unfinished = 1;
        unsigned x1, x2;
        int j1, j2;
        row_top<false>(row, price, owner, -2, m, lane, m > 1 ? 2 : 1, x1, j1,
                       x2, j2);
        if (lane == 0) {
          const float v1 = bits_value(x1);
          const float v2 = m > 1 ? bits_value(x2) : __fsub_rn(v1, eps);
          const float bid =
              __fadd_rn(__fadd_rn(price[j1], __fsub_rn(v1, v2)), eps);
          post_bid(best, j1, bid, r);
        }
      }
    }
    // the barrier after the bids: none was posted if nothing is unfinished
    if (!__syncthreads_or(unfinished)) break;

    // each column bid on goes to its best bid
    for (int j = tid; j < m; j += THREADS) {
      const u64 key = best[j];
      if (key == 0ull) continue;
      best[j] = 0ull;
      const int who = (int)(0xffffffffu - (unsigned)(key & 0xffffffffull));
      const int old = owner[j];
      price[j] = from_order_bits((unsigned)(key >> 32));
      owner[j] = who;
      if (capacity) {
        atomicAdd(rowstate + who, 1);
        if (old >= 0) atomicSub(rowstate + old, 1);
      } else {
        // the winner held nothing, the evicted row held only j
        if (old >= 0) rowstate[old] = -1;
        rowstate[who] = j;
      }
    }
    __syncthreads();
    ++it;
  }

  if (tid == 0) rounds_out[p] = it;
  if (!capacity) {
    for (int r = tid; r < n; r += THREADS)
      out[r] = r < nv ? rowstate[r] : -1;
    return;
  }
  for (int r = tid; r < n; r += THREADS) out[r] = -1;
  __syncthreads();
  // class c's columns in ascending order to rows c, c + g, ...
  const int g = live;
  for (int c = warp; c < g && c < rows; c += WARPS) {
    int base = 0;
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      const bool mine = j < m && owner[j] == c;
      const unsigned ball = __ballot_sync(FULL, mine);
      if (mine) {
        const int rank = base + __popc(ball & ((1u << lane) - 1u));
        if (c + g * rank < n) out[c + g * rank] = j;
      }
      base += __popc(ball);
    }
  }
}

}  // namespace

extern "C" int auction_f32(const float* cost, const int* n_valid,
                           int* col4row, int* rounds, int P, int n, int m,
                           int repeat, float eps_frac, int max_iters,
                           cudaStream_t stream) {
  const int rows = repeat > 1 ? n / repeat : n;
  const size_t shared = (size_t)m * 16 + (size_t)rows * 4;
  cudaError_t err = cudaFuncSetAttribute(
      auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shared);
  if (err != cudaSuccess) return (int)err;
  auction_kernel<<<P, THREADS, shared, stream>>>(cost, n_valid, col4row,
                                                 rounds, n, m, repeat,
                                                 eps_frac, max_iters);
  return (int)cudaGetLastError();
}
