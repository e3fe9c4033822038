// Exact 3x3x3 neighbour maps of voxel levels over sorted packed keys
// (Hopper).
//
// Replaces the TPU kernel vdetr_tpu/ops/map_kernel.py:window_map
// (_make_map_kernel, driven by stencil_map). Function, per map, batch row
// b, query row v and offset k = 3 * g + e (g = (dx, dy) group, x-major;
// e = dz + 1, z-fastest):
//   nbr[b, k, v] = the row of pack(s * q[v] + off[k]) in b's sorted input
//                  keys, V_in for a miss, an out-of-range neighbour or an
//                  invalid query row,
// int32 (B, 27, V), with s = 1 for a level's own map and s = 2 for a
// stride-2 map (the queries 2 o of the coarser level's coords o). Its
// contract in the JAX package is sparse_conv._zrun_neighbors, and the
// map must equal it bit for bit. One launch builds one map or two: a
// stage's stride-2 map and its level map are built back to back, so they
// share a launch (the wrapper's kernel_map_pair).
//
// The TPU kernel resolves a 128-row tile against two key windows per
// group with integer compares, flags the rows it cannot decide (`bad`) and
// leaves them to an exact patch, because Mosaic has no gather. Here every
// row is decided by a search, so there is no patch.
//
// What bounds it on the H100: the dependent loads of the binary searches
// (~17 steps into a 131072-key table), not bytes or operations; and, on
// the main path, the launches themselves (nine maps a forward, each a few
// microseconds). Design: the z-run trick of _zrun_neighbors: for one (dx,
// dy) group the three dz keys are consecutive integers, so one thread per
// (query row, group) looks up the group's lowest in-range key and
// compares the next <= 3 table keys. Within a group a block's query rows
// have ascending target keys (a level is stored in key order, 2 o keeps
// that order, and a fixed (dx, dy) shift keeps it among the rows whose
// neighbour is in range), so all of the block's hits lie in one window of
// the table, [lower_bound(least target), upper_bound(largest target)).
// A block takes 1024 rows (4 a thread) of one group. Two of its warps
// find the window's two ends at once, each a 32-way search of ~4
// dependent loads (warp_search); the block stages the window in shared
// memory and runs its rows' searches there, a thread's four in lockstep
// so that their loads overlap: shared loads instead of dependent L2
// loads, ~1100 keys staged for 1024 rows of the stem's stride-2 map.
// (Staging by cp.async, or searching row by row, was 7-14% slower in a
// trial of this form's variants on the card; trial not in the repo.) A block whose window holds more than WINDOW keys searches
// the table in global memory instead, with the same result. A first form
// with 256-row blocks and the two ends searched by two threads of one
// warp (serialized by the divergence) ran 2.7x slower than the kernel it
// replaced (PERF.md §6). Neighbours are bounds-checked per axis before
// packing, so a z of -1 or gz never aliases the key of the next y row
// (nor y the next x slice). A warp's threads take consecutive query rows
// of one group: their writes are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_conv.cuh"

namespace {

using namespace sparse_conv;  // lower_bound, KV

constexpr int KEY_SENTINEL = 0x7fffffff;  // empty table slot (never a hit)
constexpr int MAP_THREADS = 256;
constexpr int ROWS = 4;                   // query rows per thread
constexpr int TILE = ROWS * MAP_THREADS;  // query rows per block
constexpr int WINDOW = 8192;              // keys staged per block (32 KB)

struct MapDesc {
  const int* keys;       // (B, V_in) ascending
  const int* coords;     // (B, V, 3); the queries are scale * coords
  const uint8_t* valid;  // (B, V)
  int* nbr;              // (B, 27, V)
  int V_in, V, gx, gy, gz, scale, tiles;
};

// The first index in [0, n) whose key is >= key (UPPER: > key), n if none,
// found by the 32 lanes of a warp together: each step probes the last
// index of 32 equal segments of the range left and keeps the segment
// where the answer lies, so ~log32(n) dependent loads (4 at 131072 keys)
// instead of log2(n). Every lane of the warp must call it.
template <bool UPPER>
__device__ __forceinline__ int warp_search(const int* keys, int n, int key,
                                           int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int pos = lo + (lane + 1) * step - 1;
    const bool below =
        pos < hi && (UPPER ? keys[pos] <= key : keys[pos] < key);
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    const int next = lo + c * step;
    hi = min(hi, next + step - 1);
    lo = next;
  }
  return lo;
}

// grid (map 0's row tiles + map 1's, 9 groups, B)
__global__ void __launch_bounds__(MAP_THREADS)
map_kernel(MapDesc m0, MapDesc m1) {
  __shared__ int s_keys[WINDOW];
  __shared__ int s_lo[MAP_THREADS / 32], s_hi[MAP_THREADS / 32];
  __shared__ int s_win[2];
  const bool second = blockIdx.x >= (unsigned)m0.tiles;
  const int tile = second ? blockIdx.x - m0.tiles : blockIdx.x;
  // this block's map, field by field (no copy of the parameter structs)
  const int V_in = second ? m1.V_in : m0.V_in;
  const int V = second ? m1.V : m0.V;
  const int gx = second ? m1.gx : m0.gx, gy = second ? m1.gy : m0.gy;
  const int gz = second ? m1.gz : m0.gz;
  const int scale = second ? m1.scale : m0.scale;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int* keys = (second ? m1.keys : m0.keys) + (size_t)b * V_in;
  const int* coords = (second ? m1.coords : m0.coords) + (size_t)b * V * 3;
  const uint8_t* valid = (second ? m1.valid : m0.valid) + (size_t)b * V;
  int* nbr = (second ? m1.nbr : m0.nbr) + ((size_t)b * KV + 3 * g) * V;

  // the target keys of this thread's rows for the group: [base + zlo,
  // base + zhi] where `want`
  int base[ROWS], zc[ROWS], zlo[ROWS], zhi[ROWS];
  bool want[ROWS];
  int lo = KEY_SENTINEL, hi = -1;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int v = tile * TILE + j * MAP_THREADS + tid;
    want[j] = false;
    base[j] = zc[j] = zlo[j] = 0;
    zhi[j] = -1;
    if (v < V && valid[v]) {
      const int* qc = coords + (size_t)v * 3;
      const int x = scale * qc[0] + g / 3 - 1;
      const int y = scale * qc[1] + g % 3 - 1;
      zc[j] = scale * qc[2];
      zlo[j] = max(zc[j] - 1, 0);
      zhi[j] = min(zc[j] + 1, gz - 1);
      want[j] = x >= 0 && x < gx && y >= 0 && y < gy && zlo[j] <= zhi[j];
      base[j] = (x * gy + y) * gz;  // key of (x, y, 0)
      if (want[j]) {
        lo = min(lo, base[j] + zlo[j]);
        hi = max(hi, base[j] + zhi[j]);
      }
    }
  }
  // the block's window: [first key >= the least target, first key > the
  // largest target), its two ends searched by warps 0 and 1 at once
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp < 2) {
    int least = KEY_SENTINEL, top = -1;
    for (int w = 0; w < MAP_THREADS / 32; ++w) {
      least = min(least, s_lo[w]);
      top = max(top, s_hi[w]);
    }
    const int key = warp == 0 ? least : top;
    const int end = top < 0 ? 0  // no target in the block
                    : warp == 0 ? warp_search<false>(keys, V_in, key, lane)
                                : warp_search<true>(keys, V_in, key, lane);
    if (lane == 0) s_win[warp] = end;
  }
  __syncthreads();
  const int w0 = s_win[0];
  const int n = max(s_win[1] - w0, 0);
  const bool staged = n <= WINDOW;
  if (staged) {
    for (int i = tid; i < n; i += MAP_THREADS) s_keys[i] = keys[w0 + i];
    __syncthreads();
  }

  // lower_bound of each row's least target, the ROWS searches in lockstep
  // (the window's length alone sets the steps, so they interleave)
  int pos[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) pos[j] = 0;
  if (staged) {
    int len = n;
    while (len > 1) {
      const int half = len >> 1;
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        pos[j] += s_keys[pos[j] + half - 1] < base[j] + zlo[j] ? half : 0;
      len -= half;
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      pos[j] += n > 0 && s_keys[pos[j]] < base[j] + zlo[j];
  }

#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int v = tile * TILE + j * MAP_THREADS + tid;
    int idx[3] = {V_in, V_in, V_in};
    if (want[j]) {
      // keys are unique and ascending: the next <= 3 keys that are still
      // within [base + zlo, base + zhi] are exactly the hits
      const int t1 = base[j] + zhi[j];
      const int* tab = staged ? s_keys : keys;
      const int len = staged ? n : V_in;
      const int p =
          staged ? pos[j] : lower_bound(keys, V_in, base[j] + zlo[j]);
      for (int s = 0; s < 3 && p + s < len; ++s) {
        const int key = tab[p + s];
        if (key > t1 || key == KEY_SENTINEL) break;
        idx[key - base[j] - zc[j] + 1] = (staged ? w0 : 0) + p + s;
      }
    }
    if (v < V) {
      nbr[v] = idx[0];
      nbr[(size_t)V + v] = idx[1];
      nbr[(size_t)2 * V + v] = idx[2];
    }
  }
}

MapDesc desc(const void* keys, const void* coords, const void* valid,
             void* nbr, int V_in, int V, int gx, int gy, int gz, int scale) {
  return MapDesc{(const int*)keys, (const int*)coords, (const uint8_t*)valid,
                 (int*)nbr, V_in, V, gx, gy, gz, scale,
                 (V + TILE - 1) / TILE};
}

}  // namespace

// One launch builds map 0 and, when nbr1 is not null, map 1 (both over
// batch rows B). Map i: keys (B, V_in_i), queries scale_i * coords_i
// (B, V_i, 3) with validity (B, V_i), extent (gx_i, gy_i, gz_i), result
// nbr_i (B, 27, V_i). Returns cudaErrorInvalidValue (1) for a scale other
// than 1 or 2.
extern "C" int kernel_map_i32(
    const void* keys0, const void* coords0, const void* valid0, void* nbr0,
    int V_in0, int V0, int gx0, int gy0, int gz0, int scale0,
    const void* keys1, const void* coords1, const void* valid1, void* nbr1,
    int V_in1, int V1, int gx1, int gy1, int gz1, int scale1, int B,
    void* stream) {
  if (scale0 < 1 || scale0 > 2 || (nbr1 != nullptr && (scale1 < 1 ||
                                                       scale1 > 2)))
    return (int)cudaErrorInvalidValue;
  const MapDesc m0 =
      desc(keys0, coords0, valid0, nbr0, V_in0, V0, gx0, gy0, gz0, scale0);
  MapDesc m1 = m0;
  m1.tiles = 0;
  if (nbr1 != nullptr)
    m1 = desc(keys1, coords1, valid1, nbr1, V_in1, V1, gx1, gy1, gz1,
              scale1);
  if (B > 0 && m0.tiles + m1.tiles > 0) {
    dim3 grid(m0.tiles + m1.tiles, 9, B);
    map_kernel<<<grid, MAP_THREADS, 0, (cudaStream_t)stream>>>(m0, m1);
  }
  return (int)cudaGetLastError();
}
