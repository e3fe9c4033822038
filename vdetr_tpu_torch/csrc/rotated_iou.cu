// Kernel R: the rotated GIoU's bird's-eye intersection areas (Hopper), and
// their gradient in the predictions' rects.
//
// Not the port of a TPU kernel: the JAX criterion computes this function
// in XLA, outside Pallas, as vdetr_tpu/geometry/iou.py:_clip_quad_quad (a
// fori_loop over a 16-vertex buffer inside a lax.scan over the clip
// edges) vmapped over every (prediction, ground truth) pair of every
// matching job; its gradient is jax.grad through that loop. The plain
// PyTorch version is ops/rotated_iou.py:clip_quad_quad_plain.
//
// Function, per pair (b, q, k) with gate[b, q, k] set (else 0): clip the
// quad rect1[b, q] (4 vertices) by the convex CCW quad rect2[b, k],
// Sutherland-Hodgman, one clip edge at a time (cp1 = clip[(e + 3) % 4],
// cp2 = clip[e]): a vertex p is inside when
//   d.x * (p.y - cp1.y) > d.y * (p.x - cp1.x),  d = cp2 - cp1 (strict);
// walking the live vertices e with s the one before (the last for the
// first), an edge that crosses appends its intersection
//   dp = s - e, dc = -d, n1 = cp1 x cp2, n2 = s x e,
//   n3 = 1 / (dc.x dp.y - dc.y dp.x + 1e-30),
//   x = ((n1 dp.x - n2 dc.x) n3, (n1 dp.y - n2 dc.y) n3),
// and an inside e is appended; slots past the 16th are dropped (reads
// past it clamped), as JAX's scatter and gather do. The area is
// 0.5 |sum_i x_i y_{i+1} - y_i x_{i+1}| over the n live vertices, summed
// in slot order (the next of the last is the first), 0 when n < 3.
//
// Bit for bit with the plain version on the card: every f32 operation is
// the plain version's, in its order, rounded on its own (__fmul_rn,
// __fsub_rn, __fadd_rn, __fdiv_rn: nvcc contracts nothing), and the
// plain version's sum over the unused slots adds zeros.
//
// Forward: a block takes ROWS prediction rows of one batch row and every
// column; the batch row's ground-truth quads are staged in shared memory
// (32 bytes each); a thread takes a pair at a time, neighbouring threads
// neighbouring columns (coalesced writes). A gated-off pair skips the
// clip. The clip runs over the live vertices only, in a thread's local
// arrays (16 slots, 8 used at most by convex quads).
//
// Backward (d rect1 only): one thread a (b, q) row walks its columns in
// order, skips gated-off pairs and zero cotangents (only the matched
// pairs of a criterion job are nonzero), replays the pair's clip keeping
// every stage's polygon and where each vertex came from (a copy of input
// vertex i, or the intersection of the edge ending at i), then takes the
// shoelace's gradient back through the four stages to the subject's four
// vertices. The row's sum runs in column order: no atomics, the same bits
// from launch to launch. An intersection that was not appended has no
// gradient (the plain version's denominator 1 there does the same).
//
// What bounds it: operations, 5 flops an inside test of a live vertex and
// 18 an intersection, four clip edges and the shoelace, 100-300 flops a
// clipped pair (ops/rotated_iou.py:clip_flops), against 32 bytes of rects,
// one of gate and 4 of output a pair; the pairs are independent, so the
// card is filled at the published criterion's 327680 pairs a job.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXV = 16;
constexpr int THREADS = 256;
constexpr int ROWS = 4;
constexpr int BWD_THREADS = 128;

struct Poly {
  float x[MAXV], y[MAXV];
};

struct Edge {
  float c1x, c1y, dx, dy, dcx, dcy, n1;
};

__device__ __forceinline__ Edge make_edge(const float* clip, int e) {
  const int a = (e + 3) & 3;
  Edge g;
  g.c1x = clip[2 * a];
  g.c1y = clip[2 * a + 1];
  const float c2x = clip[2 * e], c2y = clip[2 * e + 1];
  g.dx = __fsub_rn(c2x, g.c1x);
  g.dy = __fsub_rn(c2y, g.c1y);
  g.dcx = -g.dx;
  g.dcy = -g.dy;
  g.n1 = __fsub_rn(__fmul_rn(g.c1x, c2y), __fmul_rn(g.c1y, c2x));
  return g;
}

__device__ __forceinline__ bool inside(const Edge& g, float px, float py) {
  return __fmul_rn(g.dx, __fsub_rn(py, g.c1y)) >
         __fmul_rn(g.dy, __fsub_rn(px, g.c1x));
}

__device__ __forceinline__ void intersect(const Edge& g, float sx, float sy,
                                          float ex, float ey, float& ox,
                                          float& oy) {
  const float dpx = __fsub_rn(sx, ex), dpy = __fsub_rn(sy, ey);
  const float n2 = __fsub_rn(__fmul_rn(sx, ey), __fmul_rn(sy, ex));
  const float den = __fadd_rn(
      __fsub_rn(__fmul_rn(g.dcx, dpy), __fmul_rn(g.dcy, dpx)), 1e-30f);
  const float n3 = __fdiv_rn(1.0f, den);
  ox = __fmul_rn(__fsub_rn(__fmul_rn(g.n1, dpx), __fmul_rn(n2, g.dcx)), n3);
  oy = __fmul_rn(__fsub_rn(__fmul_rn(g.n1, dpy), __fmul_rn(n2, g.dcy)), n3);
}

// One clip edge: `in` (n live vertices) -> `out`; returns the output
// count (may pass MAXV: those writes are dropped). src[o]: o's origin, i
// for a copy of input vertex i, MAXV + i for the intersection of the
// edge that ends at input vertex i. src may be null.
__device__ int clip_edge(const Poly& in, int n, const Edge& g, Poly& out,
                         signed char* src) {
  const int nn = n < MAXV ? n : MAXV;
  if (nn <= 0) return 0;
  const int last = n - 1 < MAXV - 1 ? n - 1 : MAXV - 1;
  float sx = in.x[last], sy = in.y[last];
  bool ins_s = inside(g, sx, sy);
  int m = 0;
  for (int i = 0; i < nn; ++i) {
    const float ex = in.x[i], ey = in.y[i];
    const bool ins_e = inside(g, ex, ey);
    if (ins_e != ins_s) {
      if (m < MAXV) {
        intersect(g, sx, sy, ex, ey, out.x[m], out.y[m]);
        if (src) src[m] = (signed char)(MAXV + i);
      }
      ++m;
    }
    if (ins_e) {
      if (m < MAXV) {
        out.x[m] = ex;
        out.y[m] = ey;
        if (src) src[m] = (signed char)i;
      }
      ++m;
    }
    sx = ex;
    sy = ey;
    ins_s = ins_e;
  }
  return m;
}

__device__ __forceinline__ int next_slot(int i, int n) {
  return i + 1 < n ? (i + 1 < MAXV - 1 ? i + 1 : MAXV - 1) : 0;
}

// the signed shoelace sum of the n live vertices, in slot order
__device__ float shoelace(const Poly& p, int n) {
  const int nn = n < MAXV ? n : MAXV;
  float t = 0.0f;
  for (int i = 0; i < nn; ++i) {
    const int j = next_slot(i, n);
    const float c = __fsub_rn(__fmul_rn(p.x[i], p.y[j]),
                              __fmul_rn(p.y[i], p.x[j]));
    t = i == 0 ? c : __fadd_rn(t, c);
  }
  return t;
}

__device__ __forceinline__ void load_quad(Poly& p, const float* q) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    p.x[v] = q[2 * v];
    p.y[v] = q[2 * v + 1];
  }
}

__device__ float clip_area(const float* subject, const float* clip) {
  Poly a, b;
  load_quad(a, subject);
  int n = 4;
  for (int e = 0; e < 4; e += 2) {
    n = clip_edge(a, n, make_edge(clip, e), b, nullptr);
    n = clip_edge(b, n, make_edge(clip, e + 1), a, nullptr);
  }
  if (n < 3) return 0.0f;
  return __fmul_rn(0.5f, fabsf(shoelace(a, n)));
}

__global__ void __launch_bounds__(THREADS)
rotated_areas_kernel(const float* __restrict__ rect1,
                     const float* __restrict__ rect2,
                     const uint8_t* __restrict__ gate,
                     float* __restrict__ out, int K1, int K2) {
  extern __shared__ float gt[];  // K2 quads of this batch row
  const int b = blockIdx.y;
  const float* r2 = rect2 + (size_t)b * K2 * 8;
  for (int t = threadIdx.x; t < K2 * 8; t += THREADS) gt[t] = r2[t];
  __syncthreads();
  const int q0 = blockIdx.x * ROWS;
  const int rows = K1 - q0 < ROWS ? K1 - q0 : ROWS;
  const size_t base = ((size_t)b * K1 + q0) * K2;
  for (int p = threadIdx.x; p < rows * K2; p += THREADS) {
    const int q = q0 + p / K2, k = p % K2;
    float area = 0.0f;
    if (gate[base + p])
      area = clip_area(rect1 + ((size_t)b * K1 + q) * 8, gt + k * 8);
    out[base + p] = area;
  }
}

// d(x, y of the intersection) -> d(s), d(e), the edge constants fixed
__device__ __forceinline__ void intersect_grad(const Edge& g, float sx,
                                               float sy, float ex, float ey,
                                               float gx, float gy,
                                               float& gsx, float& gsy,
                                               float& gex, float& gey) {
  const float dpx = sx - ex, dpy = sy - ey;
  const float n2 = sx * ey - sy * ex;
  const float den = g.dcx * dpy - g.dcy * dpx + 1e-30f;
  const float n3 = 1.0f / den;
  const float a0 = g.n1 * dpx - n2 * g.dcx;
  const float a1 = g.n1 * dpy - n2 * g.dcy;
  const float ga0 = gx * n3, ga1 = gy * n3;
  const float gn3 = gx * a0 + gy * a1;
  const float gden = -gn3 * (n3 * n3);
  const float gdpx = ga0 * g.n1 - gden * g.dcy;
  const float gdpy = ga1 * g.n1 + gden * g.dcx;
  const float gn2 = -(ga0 * g.dcx + ga1 * g.dcy);
  gsx = gdpx + gn2 * ey;
  gsy = gdpy - gn2 * ex;
  gex = -gdpx - gn2 * sy;
  gey = -gdpy + gn2 * sx;
}

// cot * d area / d subject, added into g (4 vertices x (x, y))
__device__ void clip_area_grad(const float* subject, const float* clip,
                               float cot, float* g) {
  Poly st[5];
  signed char src[4][MAXV];
  int cnt[5];
  Edge edges[4];
  load_quad(st[0], subject);
  cnt[0] = 4;
  for (int e = 0; e < 4; ++e) {
    edges[e] = make_edge(clip, e);
    cnt[e + 1] = clip_edge(st[e], cnt[e], edges[e], st[e + 1], src[e]);
  }
  const int n = cnt[4];
  if (n < 3) return;
  const float t = shoelace(st[4], n);
  const float sgn = t > 0.0f ? 1.0f : (t < 0.0f ? -1.0f : 0.0f);
  const float gt = cot * 0.5f * sgn;
  if (gt == 0.0f) return;
  float gx[MAXV], gy[MAXV];
  const int nn = n < MAXV ? n : MAXV;
  for (int i = 0; i < MAXV; ++i) gx[i] = gy[i] = 0.0f;
  for (int i = 0; i < nn; ++i) {
    const int j = next_slot(i, n);
    gx[i] += gt * st[4].y[j];
    gy[j] += gt * st[4].x[i];
    gy[i] -= gt * st[4].x[j];
    gx[j] -= gt * st[4].y[i];
  }
  for (int e = 3; e >= 0; --e) {
    const Poly& in = st[e];
    const int nin = cnt[e];
    const int nout = cnt[e + 1] < MAXV ? cnt[e + 1] : MAXV;
    float px[MAXV], py[MAXV];
    for (int i = 0; i < MAXV; ++i) px[i] = py[i] = 0.0f;
    for (int o = 0; o < nout; ++o) {
      const int c = src[e][o];
      if (c < MAXV) {
        px[c] += gx[o];
        py[c] += gy[o];
      } else {
        const int i = c - MAXV;
        const int last = nin - 1 < MAXV - 1 ? nin - 1 : MAXV - 1;
        const int si = i == 0 ? last : i - 1;
        float gsx, gsy, gex, gey;
        intersect_grad(edges[e], in.x[si], in.y[si], in.x[i], in.y[i],
                       gx[o], gy[o], gsx, gsy, gex, gey);
        px[si] += gsx;
        py[si] += gsy;
        px[i] += gex;
        py[i] += gey;
      }
    }
    for (int i = 0; i < MAXV; ++i) {
      gx[i] = px[i];
      gy[i] = py[i];
    }
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    g[2 * v] += gx[v];
    g[2 * v + 1] += gy[v];
  }
}

__global__ void __launch_bounds__(BWD_THREADS)
rotated_areas_bwd_kernel(const float* __restrict__ rect1,
                         const float* __restrict__ rect2,
                         const uint8_t* __restrict__ gate,
                         const float* __restrict__ grad,
                         float* __restrict__ d1, int B, int K1, int K2) {
  const int row = blockIdx.x * BWD_THREADS + threadIdx.x;
  if (row >= B * K1) return;
  const int b = row / K1;
  const float* subject = rect1 + (size_t)row * 8;
  const size_t base = (size_t)row * K2;
  float g[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) g[v] = 0.0f;
  for (int k = 0; k < K2; ++k) {
    const float cot = grad[base + k];
    if (cot == 0.0f || !gate[base + k]) continue;
    clip_area_grad(subject, rect2 + ((size_t)b * K2 + k) * 8, cot, g);
  }
#pragma unroll
  for (int v = 0; v < 8; ++v) d1[(size_t)row * 8 + v] = g[v];
}

}  // namespace

extern "C" int rotated_areas_f32(const float* rect1, const float* rect2,
                                 const uint8_t* gate, const float* grad,
                                 float* out, int B, int K1, int K2,
                                 int backward, cudaStream_t stream) {
  if (backward) {
    const int rows = B * K1;
    rotated_areas_bwd_kernel<<<(rows + BWD_THREADS - 1) / BWD_THREADS,
                               BWD_THREADS, 0, stream>>>(
        rect1, rect2, gate, grad, out, B, K1, K2);
    return (int)cudaGetLastError();
  }
  const size_t shared = (size_t)K2 * 8 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rotated_areas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((K1 + ROWS - 1) / ROWS, B);
  rotated_areas_kernel<<<grid, THREADS, shared, stream>>>(rect1, rect2, gate,
                                                          out, K1, K2);
  return (int)cudaGetLastError();
}
