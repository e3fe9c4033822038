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
// Forward: a thread a pair of the flat (b, q, k) index, nothing staged:
// neighbouring threads read neighbouring gate bytes and write
// neighbouring areas (a warp's read is one 32-byte sector, its write 128
// contiguous bytes). A gated pair divides its flat index by K2 and K1
// (in 32 bits where the pairs fit) to find its quads and reads both
// through the read-only cache (the gate passes ~0.1% of a criterion
// job's pairs, so these reads are rare, and any K2 is taken); a pair the
// gate turns off writes 0. One pair a thread, because a thread's clips
// run in series: with 4 pairs a thread (a 4-byte gate read, a 16-byte
// store) neighbouring gated pairs made the launch slower. The clip runs
// over the live vertices only, in a thread's local arrays (16 slots, 8
// used at most by convex quads).
//
// Backward (d rect1 only): a warp owns a (b, q) row. Its lanes read the
// row's cotangents and gate bytes in 128-column passes, 4 consecutive
// columns a lane (16 and 4 bytes where aligned, scalar reads
// otherwise); a ballot a pass finds the lanes with a hit (a nonzero
// cotangent on a gated pair: only the matched pairs of a criterion job
// carry one). The hits are replayed in column order, each by the lane
// that owns it, through clip_area_grad on the row's running sum g, which
// every lane holds and takes from that lane by shuffles after each hit:
// the same calls on the same g in the same order as one thread walking
// the row's columns, so the same bits from launch to launch.
// clip_area_grad replays the pair's clip keeping every stage's polygon
// and where each vertex came from (a copy of input vertex i, or the
// intersection of the edge ending at i), then takes the shoelace's
// gradient back through the four stages to the subject's four vertices.
// An intersection that was not appended has no gradient (the plain
// version's denominator 1 there does the same).
//
// What bounds it: the bytes. A job moves 32 bytes of rects a row and
// column, one byte of gate and 4 of area a pair (forward), 4 of
// cotangent and one of gate a pair (backward); the clips (5 flops an
// inside test of a live vertex, 18 an intersection, four clip edges and
// the shoelace, 100-300 flops a clipped pair: ops/rotated_iou.py:
// clip_flops) run on the few gated pairs only. At B = 1 a job's 1024 rows
// are 1024 warps of the backward and 1280 blocks of the forward. What is
// left above the bound is a launch's fixed cost and the latency of one
// thread's clip (forward) or one pair's replay and its reverse
// (backward) on the pairs that have one: a chain of dependent f32
// operations over arrays in local memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXV = 16;
constexpr int THREADS = 256;
constexpr int BWD_THREADS = 128;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

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
                     float* __restrict__ out, int K1, int K2,
                     long long total) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= total) return;
  float area = 0.0f;
  if (__ldg(gate + p)) {
    // pair p = (b K1 + q) K2 + k: its quads, read before the clip (32-bit
    // divisions where the pairs fit in 32 bits)
    long long row, b;
    if (total <= 0xffffffffll) {
      const unsigned r = (unsigned)p / (unsigned)K2;
      row = r;
      b = r / (unsigned)K1;
    } else {
      row = p / K2;
      b = row / K1;
    }
    const float* s = rect1 + row * 8;
    const float* c = rect2 + (b * K2 + (p - row * K2)) * 8;
    float subject[8], clip[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      subject[i] = __ldg(s + i);
      clip[i] = __ldg(c + i);
    }
    area = clip_area(subject, clip);
  }
  out[p] = area;
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

// v[i] without a dynamic index (which would put v in local memory)
__device__ __forceinline__ float pick4(const float (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

__global__ void __launch_bounds__(BWD_THREADS)
rotated_areas_bwd_kernel(const float* __restrict__ rect1,
                         const float* __restrict__ rect2,
                         const uint8_t* __restrict__ gate,
                         const float* __restrict__ grad,
                         float* __restrict__ d1, int B, int K1, int K2,
                         int vec) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * BWD_WARPS + (threadIdx.x >> 5);
  if (row >= (long long)B * K1) return;  // the whole warp
  const long long b = row / K1;
  const float* subject = rect1 + row * 8;
  const float* cot_row = grad + row * K2;
  const uint8_t* gate_row = gate + row * K2;
  float g[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) g[v] = 0.0f;
  for (int k0 = 0; k0 < K2; k0 += 128) {
    const int k = k0 + 4 * lane;  // this lane's 4 columns
    float cot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    unsigned on = 0;  // gate bytes, one a column
    if (vec && k + 4 <= K2) {
      const float4 c = __ldg(reinterpret_cast<const float4*>(cot_row + k));
      cot[0] = c.x;
      cot[1] = c.y;
      cot[2] = c.z;
      cot[3] = c.w;
      on = __ldg(reinterpret_cast<const unsigned*>(gate_row + k));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (k + i < K2) {
          cot[i] = __ldg(cot_row + k + i);
          on |= (unsigned)__ldg(gate_row + k + i) << (8 * i);
        }
    }
    unsigned hits = 0;  // bit i: column k + i carries a cotangent, gated
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (cot[i] != 0.0f && ((on >> (8 * i)) & 0xffu)) hits |= 1u << i;
    // the hits in column order: lanes in order, each lane's in order
    for (unsigned lanes = __ballot_sync(FULL, hits != 0); lanes;
         lanes &= lanes - 1) {
      const int src = __ffs(lanes) - 1;
      for (unsigned h = __shfl_sync(FULL, hits, src); h; h &= h - 1) {
        const int i = __ffs(h) - 1;
        if (lane == src)
          clip_area_grad(subject, rect2 + (b * K2 + k + i) * 8,
                         pick4(cot, i), g);
#pragma unroll
        for (int v = 0; v < 8; ++v) g[v] = __shfl_sync(FULL, g[v], src);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int v = 0; v < 8; ++v) d1[row * 8 + v] = g[v];
  }
}

}  // namespace

extern "C" int rotated_areas_f32(const float* rect1, const float* rect2,
                                 const uint8_t* gate, const float* grad,
                                 float* out, int B, int K1, int K2,
                                 int backward, cudaStream_t stream) {
  const long long rows = (long long)B * K1;
  if (backward) {
    const int vec = K2 % 4 == 0 && (uintptr_t)grad % 16 == 0 &&
                    (uintptr_t)gate % 4 == 0;
    rotated_areas_bwd_kernel<<<(unsigned)((rows + BWD_WARPS - 1) /
                                          BWD_WARPS),
                               BWD_THREADS, 0, stream>>>(
        rect1, rect2, gate, grad, out, B, K1, K2, vec);
    return (int)cudaGetLastError();
  }
  const long long total = rows * K2;
  rotated_areas_kernel<<<(unsigned)((total + THREADS - 1) / THREADS),
                         THREADS, 0, stream>>>(rect1, rect2, gate, out, K1,
                                               K2, total);
  return (int)cudaGetLastError();
}
