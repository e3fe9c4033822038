// Exact 3x3x3 neighbour map of a voxel level over sorted packed keys
// (Hopper).
//
// Replaces the TPU kernel vdetr_tpu/ops/map_kernel.py:window_map
// (_make_map_kernel, driven by stencil_map). Function, per batch row b,
// query row v and offset k = 3 * g + e (g = (dx, dy) group, x-major;
// e = dz + 1, z-fastest):
//   nbr[b, k, v] = the row of pack(q[v] + off[k]) in b's sorted input keys,
//                  V_in for a miss, an out-of-range neighbour or an invalid
//                  query row,
// int32 (B, 27, V). Its contract in the JAX package is
// sparse_conv._zrun_neighbors, and the map must equal it bit for bit.
//
// The TPU kernel resolves a 128-row tile against two key windows per
// group with integer compares, flags the rows it cannot decide (`bad`) and
// leaves them to an exact patch, because Mosaic cannot search a table per
// row. Here a thread searches directly, so every row is decided.
//
// What bounds it on the H100: the dependent loads of the binary searches
// (~17 steps into a 131072-key table that sits in L2), not bytes or
// operations. Design: the z-run trick of _zrun_neighbors. For one (dx, dy)
// group the three dz keys are consecutive integers, so one thread per
// (query row, group) does one lower_bound for the group's lowest in-range
// key and compares the next <= 3 table keys: 9 searches per row instead
// of 27. Neighbours are bounds-checked per axis before packing, so a z of
// -1 or gz never aliases the key of the next y row (nor y the next x
// slice). Threads of a warp take consecutive query rows of one group:
// their searches walk nearby keys and their writes are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_conv.cuh"

namespace {

using namespace sparse_conv;

constexpr int KEY_SENTINEL = 0x7fffffff;  // empty table slot (never a hit)
constexpr int MAP_THREADS = 256;

// grid (ceil(V / 256), 9 groups, B)
__global__ void __launch_bounds__(MAP_THREADS)
map_kernel(const int* __restrict__ in_keys,      // (B, V_in) ascending
           const int* __restrict__ q_coords,     // (B, V, 3)
           const uint8_t* __restrict__ q_valid,  // (B, V)
           int* __restrict__ nbr,                // (B, 27, V)
           int V_in, int V, int gx, int gy, int gz) {
  const int v = blockIdx.x * MAP_THREADS + threadIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  if (v >= V) return;
  int idx[3] = {V_in, V_in, V_in};
  const size_t r = (size_t)b * V + v;
  if (q_valid[r]) {
    const int* qc = q_coords + r * 3;
    const int x = qc[0] + g / 3 - 1;
    const int y = qc[1] + g % 3 - 1;
    const int z = qc[2];
    const int zlo = max(z - 1, 0), zhi = min(z + 1, gz - 1);
    if (x >= 0 && x < gx && y >= 0 && y < gy && zlo <= zhi) {
      const int base = (x * gy + y) * gz;  // key of (x, y, 0)
      const int* keys = in_keys + (size_t)b * V_in;
      const int pos = lower_bound(keys, V_in, base + zlo);
      // keys are unique and ascending: the next <= 3 keys that are still
      // within [base + zlo, base + zhi] are exactly the hits
      for (int s = 0; s < 3 && pos + s < V_in; ++s) {
        const int key = keys[pos + s];
        if (key > base + zhi || key == KEY_SENTINEL) break;
        idx[key - base - z + 1] = pos + s;
      }
    }
  }
  int* o = nbr + ((size_t)b * KV + 3 * g) * V + v;
  o[0] = idx[0];
  o[(size_t)V] = idx[1];
  o[(size_t)2 * V] = idx[2];
}

}  // namespace

extern "C" int kernel_map_i32(const void* in_keys, const void* q_coords,
                              const void* q_valid, void* nbr, int B, int V_in,
                              int V, int gx, int gy, int gz, void* stream) {
  if (B > 0 && V > 0) {
    dim3 grid((V + MAP_THREADS - 1) / MAP_THREADS, 9, B);
    map_kernel<<<grid, MAP_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)in_keys, (const int*)q_coords, (const uint8_t*)q_valid,
        (int*)nbr, V_in, V, gx, gy, gz);
  }
  return (int)cudaGetLastError();
}
