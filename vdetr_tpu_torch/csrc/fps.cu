// Greedy furthest point sampling (Hopper).
//
// Replaces the TPU kernel vdetr_tpu/ops/fps.py:fps_pallas (_fps_kernel),
// whose contract is fps_jax: start at index 0; each step pick the point
// with the largest running min squared distance to the picked set, first
// index on ties; points with |p|^2 <= 1e-3 are never picked and never
// update their running distance.
//
// Squared norms and distances are written with explicit round-to-nearest
// intrinsics, fma(dz, dz, fma(dy, dy, dx * dx)): the rounding of the plain
// version and of fps_jax as XLA evaluates it. Exact distance ties are
// common on voxel lattice points, so any other order picks other indices.
//
// What bounds it on the H100: 4095 dependent steps, each a pass over all
// N points and an argmax over them -- latency. One block alone re-reads
// the 384 KB of coordinates (N = 32768) from L2 every step, at one SM's
// L2 bandwidth. Design: a thread-block cluster of 8 CTAs per batch row;
// each CTA keeps its eighth of the points (coordinates and running
// distances, 64 KB at N = 32768) in shared memory, so a step reads no
// global memory. Each CTA reduces its candidate (warp shuffles, then
// over warps) and writes it, with the point's coordinates, into a slot of
// every CTA of the cluster (distributed shared memory); one cluster
// barrier later every CTA reduces the 8 slots to the same winner. The
// slots are double-buffered by step parity, so one cluster barrier per
// step suffices. Past 14.5k points per CTA the chunk stays in global
// memory (the same code through another pointer).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;     // CTAs per batch row (one cluster)
constexpr int NT = 512;   // threads per CTA
constexpr int SMEM_BYTES = 227 * 1024;

struct Cand {
  float val;
  int idx;
  float x, y, z;
};

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

__device__ __forceinline__ bool better(float ov, int oi, float v, int i) {
  return ov > v || (ov == v && oi < i);
}

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT)
fps_kernel(const float* __restrict__ xyz,   // (B, N, 3)
           float* __restrict__ gtemp,       // (B, N) scratch if off chip
           int64_t* __restrict__ out,       // (B, npoint)
           int N, int npoint, int chunk, int on_chip) {
  extern __shared__ float smem[];           // xyz[chunk * 3], temp[chunk]
  __shared__ Cand slots[2][CL];
  __shared__ float s_val[NT / 32];
  __shared__ int s_idx[NT / 32];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CL;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int start = rank * chunk;
  const int count = max(0, min(chunk, N - start));
  const float* gxyz = xyz + (size_t)b * N * 3;
  const float* P;
  float* T;
  if (on_chip) {
    float* sp = smem;
    for (int i = tid; i < count * 3; i += NT)
      sp[i] = gxyz[(size_t)start * 3 + i];
    P = sp;
    T = smem + (size_t)chunk * 3;
  } else {
    P = gxyz + (size_t)start * 3;
    T = gtemp + (size_t)b * N + start;
  }
  for (int i = tid; i < count; i += NT) T[i] = 1e10f;
  float cx = gxyz[0], cy = gxyz[1], cz = gxyz[2];
  if (rank == 0 && tid == 0) out[(size_t)b * npoint] = 0;
  __syncthreads();

  for (int j = 1; j < npoint; ++j) {
    float best = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = tid; i < count; i += NT) {
      const float x = P[i * 3 + 0], y = P[i * 3 + 1], z = P[i * 3 + 2];
      float cand = -1.f;
      if (!(sq_norm(x, y, z) <= 1e-3f)) {
        const float d = sq_norm(__fsub_rn(x, cx), __fsub_rn(y, cy),
                                __fsub_rn(z, cz));
        const float d2 = fminf(d, T[i]);
        T[i] = d2;
        cand = d2;
      }
      if (cand > best) { best = cand; bi = start + i; }  // i ascends
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, best, bi)) { best = ov; bi = oi; }
    }
    if (lane == 0) { s_val[warp] = best; s_idx[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      best = lane < NT / 32 ? s_val[lane] : -INFINITY;
      bi = lane < NT / 32 ? s_idx[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, best, bi)) { best = ov; bi = oi; }
      }
      best = __shfl_sync(0xffffffffu, best, 0);  // lane 0 holds the result
      bi = __shfl_sync(0xffffffffu, bi, 0);
      if (lane < CL) {  // lane r publishes this CTA's candidate to CTA r
        Cand c{best, bi, 0.f, 0.f, 0.f};
        if (bi != 0x7fffffff) {
          const int li = bi - start;
          c.x = P[li * 3 + 0];
          c.y = P[li * 3 + 1];
          c.z = P[li * 3 + 2];
        }
        Cand* dst = cluster.map_shared_rank(&slots[j & 1][rank], lane);
        *dst = c;
      }
    }
    cluster.sync();
    Cand w = slots[j & 1][0];
#pragma unroll
    for (int r = 1; r < CL; ++r) {
      const Cand c = slots[j & 1][r];
      if (better(c.val, c.idx, w.val, w.idx)) w = c;
    }
    cx = w.x;
    cy = w.y;
    cz = w.z;
    if (rank == 0 && tid == 0) out[(size_t)b * npoint + j] = w.idx;
  }
  cluster.sync();  // no CTA exits while others may still write its slots
}

}  // namespace

// temp: (B, N) float scratch, used only when a CTA's share of the points
// does not fit in shared memory. N >= 1 (the wrapper checks).
extern "C" int fps_f32(const void* xyz, void* temp, void* out, int B, int N,
                       int npoint, void* stream) {
  if (B <= 0 || npoint <= 0) return (int)cudaGetLastError();
  const int chunk = (N + CL - 1) / CL;
  const int reserved = (int)(sizeof(Cand) * 2 * CL + 8 * NT / 32 + 1024);
  const int on_chip = chunk * 16 <= SMEM_BYTES - reserved;
  const int smem = on_chip ? chunk * 16 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<<<B * CL, NT, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, (float*)temp, (int64_t*)out, N, npoint, chunk,
      on_chip);
  return (int)cudaGetLastError();
}
