// Kernel N: the greedy same-class 3D NMS of the eval step as one scan per
// scene (Hopper).
//
// Not the port of a TPU kernel: the JAX eval step computes this function
// in XLA, outside Pallas, as a `jax.lax.while_loop` of masked argmax and
// suppress (vdetr_tpu/geometry/nms.py:nms_3d_samecls_mask, called from
// vdetr_tpu/train/engine.py:_build_eval_step). Eager PyTorch would pay
// ~5 launches per step of that loop, ~5k per scene; this is one launch.
//
// Function: keep[b, k] = box k of scene b is picked by the greedy loop
// that repeatedly takes the alive box of the largest score (the lowest
// index among equal scores), keeps it, and kills every alive box of its
// class whose axis-aligned overlap with it is > thr; `valid` seeds alive.
// The wrapper (geometry/nms.py) passes the boxes' order of a stable
// descending sort of the scores; visiting the boxes once in that order and
// keeping each box still alive when it is reached picks the same boxes
// (tests/test_torch_kernel_premises.py holds the scan to the loop).
//
// The overlap is JAX's f32 formula in JAX's order, every operation
// rounded on its own (the _rn intrinsics: no fused multiply-add), so a
// pair exactly at the threshold goes the same way as in the plain loop:
//   inter = (max(xx2-xx1,0) * max(yy2-yy1,0)) * max(zz2-zz1,0)
//   ov    = inter / max((area_i + area_j) - inter, 1e-12)
//   (old_type: inter / max(area_j, 1e-12)), area = ((x2-x1)*(y2-y1))*(z2-z1)
// with i the kept box and j the box tested. Inputs are finite.
//
// Design: one block per scene. Each thread holds SLOTS boxes (k = thread
// + s * blockDim) in registers: the AABB, area, class and alive flag. The
// sorted order sits in shared memory. Step r visits box order[r]: its
// owner has published it (alive flag, AABB, area, class) into one of two
// shared records at the end of step r - 1; if it is alive (a branch that
// is uniform across the block) every thread tests its boxes against it,
// and the owner marks it kept. Then the owner of order[r + 1] publishes it
// into the other record, and one barrier ends the step.
// What bounds it: the K dependent steps, each a barrier of the block,
// ~K barriers a scene; the work (K^2 overlap tests of ~20 flops, 1024^2 x
// 20 = 21 MFLOP, ~0.3 us at 67 TFLOP/s) and the bytes (~40 KB a scene)
// are far below that floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int STATIC_SMEM = 48 * 1024;

struct Box {
  float x1, y1, z1, x2, y2, z2, area;
  int cls;
  int alive;
};

__device__ __forceinline__ float volume(float x1, float y1, float z1,
                                        float x2, float y2, float z2) {
  return __fmul_rn(__fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1)),
                   __fsub_rn(z2, z1));
}

// overlap of box j with the kept box c, in JAX's order
__device__ __forceinline__ float overlap(const Box& c, float x1, float y1,
                                         float z1, float x2, float y2,
                                         float z2, float area,
                                         bool old_type) {
  const float dx = fmaxf(__fsub_rn(fminf(c.x2, x2), fmaxf(c.x1, x1)), 0.f);
  const float dy = fmaxf(__fsub_rn(fminf(c.y2, y2), fmaxf(c.y1, y1)), 0.f);
  const float dz = fmaxf(__fsub_rn(fminf(c.z2, z2), fmaxf(c.z1, z1)), 0.f);
  const float inter = __fmul_rn(__fmul_rn(dx, dy), dz);
  const float denom =
      old_type ? area : __fsub_rn(__fadd_rn(c.area, area), inter);
  return __fdiv_rn(inter, fmaxf(denom, 1e-12f));
}

template <int SLOTS>
__global__ void __launch_bounds__(MAX_THREADS)
nms_scan_kernel(const float* __restrict__ aabbs,
                const int* __restrict__ order,
                const int* __restrict__ classes,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int K, float thr, int old_type) {
  extern __shared__ int s_order[];
  __shared__ Box cand[2];
  const int T = blockDim.x, tid = threadIdx.x;
  const size_t b = blockIdx.x;
  aabbs += b * K * 6;
  order += b * K;
  classes += b * K;
  valid += b * K;
  keep += b * K;

  float x1[SLOTS], y1[SLOTS], z1[SLOTS], x2[SLOTS], y2[SLOTS], z2[SLOTS];
  float area[SLOTS];
  int cls[SLOTS];
  bool alive[SLOTS], kept[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int k = tid + s * T;
    alive[s] = kept[s] = false;
    x1[s] = y1[s] = z1[s] = x2[s] = y2[s] = z2[s] = area[s] = 0.f;
    cls[s] = 0;
    if (k < K) {
      const float* a = aabbs + (size_t)k * 6;
      x1[s] = a[0]; y1[s] = a[1]; z1[s] = a[2];
      x2[s] = a[3]; y2[s] = a[4]; z2[s] = a[5];
      area[s] = volume(x1[s], y1[s], z1[s], x2[s], y2[s], z2[s]);
      cls[s] = classes[k];
      alive[s] = valid[k] != 0;
    }
  }
  for (int k = tid; k < K; k += T) s_order[k] = order[k];
  __syncthreads();

  // the owner of box k publishes it into cand[slot]
  auto publish = [&](int k, int slot) {
    if (k % T != tid) return;
    const int mine = k / T;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      if (s == mine) {
        cand[slot] = Box{x1[s], y1[s], z1[s], x2[s], y2[s], z2[s], area[s],
                         cls[s], alive[s] ? 1 : 0};
      }
    }
  };
  publish(s_order[0], 0);
  __syncthreads();

  for (int r = 0; r < K; ++r) {
    const Box& c = cand[r & 1];
    if (c.alive) {  // the same for every thread of the block
      const Box kc = c;
      const int o = s_order[r];
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int k = tid + s * T;
        if (k == o) {
          kept[s] = true;
          alive[s] = false;
        } else if (alive[s]) {
          const float ov = overlap(kc, x1[s], y1[s], z1[s], x2[s], y2[s],
                                   z2[s], area[s], old_type != 0);
          if ((cls[s] == kc.cls ? ov : 0.f) > thr) alive[s] = false;
        }
      }
    }
    if (r + 1 < K) publish(s_order[r + 1], (r + 1) & 1);
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int k = tid + s * T;
    if (k < K) keep[k] = kept[s] ? 1 : 0;
  }
}

template <int SLOTS>
int launch(const float* aabbs, const int* order, const int* classes,
           const uint8_t* valid, uint8_t* keep, int B, int K, float thr,
           int old_type, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)K * sizeof(int);
  if (smem > STATIC_SMEM) {
    cudaFuncSetAttribute(nms_scan_kernel<SLOTS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  nms_scan_kernel<SLOTS><<<B, threads, smem, stream>>>(
      aabbs, order, classes, valid, keep, K, thr, old_type);
  return (int)cudaGetLastError();
}

}  // namespace

// keep (B, K) bytes 0/1 = the greedy same-class NMS of each scene.
// aabbs (B, K, 6) f32 (x1, y1, z1, x2, y2, z2); order (B, K) int32, each
// row the boxes in the order of a stable descending sort of the scores;
// classes (B, K) int32; valid (B, K) bytes 0/1. K <= 16 * 1024.
extern "C" int nms_samecls_f32(const void* aabbs, const void* order,
                               const void* classes, const void* valid,
                               void* keep, int B, int K, float thr,
                               int old_type, void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaGetLastError();
  const int threads = K < MAX_THREADS ? (K + 31) / 32 * 32 : MAX_THREADS;
  const int per = (K + threads - 1) / threads;
  if (per > 16) return (int)cudaErrorInvalidValue;
  const auto* a = (const float*)aabbs;
  const auto* o = (const int*)order;
  const auto* c = (const int*)classes;
  const auto* v = (const uint8_t*)valid;
  auto* out = (uint8_t*)keep;
  auto st = (cudaStream_t)stream;
#define NMS_LAUNCH(S) \
  launch<S>(a, o, c, v, out, B, K, thr, old_type, threads, st)
  switch (per <= 1 ? 1 : per <= 2 ? 2 : per <= 4 ? 4 : per <= 8 ? 8 : 16) {
    case 1: return NMS_LAUNCH(1);
    case 2: return NMS_LAUNCH(2);
    case 4: return NMS_LAUNCH(4);
    case 8: return NMS_LAUNCH(8);
    default: return NMS_LAUNCH(16);
  }
#undef NMS_LAUNCH
}
