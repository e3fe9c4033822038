// Batched rotated 3D box IoU (host side, for the AP evaluator): the
// port's own copy of the JAX package's `csrc/box_iou.cpp`, built and
// loaded by `vdetr_tpu_torch/eval/native.py`.
//
// Native counterpart of the reference's missing Cython box_intersection
// module (utils/cython_compile.py builds box_intersection.pyx, absent from
// the tree; the fallback is per-pair Python Sutherland-Hodgman —
// utils/box_util.py:37-147). The VoteNet AP protocol computes
// n_det x n_gt exact rotated IoUs per class per scan; doing that in Python
// dominates eval wall-clock, so this is the one genuinely host-bound piece
// worth native code.
//
// Boxes are camera-frame corner arrays (8, 3): corners 0-3 the top face
// (counter-clockwise in (x, z) when traversed 3,2,1,0), corners 4-7 the
// bottom face; up is negative Y (reference utils/box_util.py:122-147).
//
// Build: g++ -O3 -shared -fPIC -o build/kernels/libbox_iou_<digest>.so
// vdetr_tpu_torch/csrc/box_iou.cpp (eval/native.py does it at first use)

#include <algorithm>
#include <cmath>
#include <cstddef>

namespace {

struct P2 {
  double x, y;
};

inline double cross(const P2 &o, const P2 &a, const P2 &b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Sutherland-Hodgman: clip `subj` (n verts) by convex CCW quad `clip`.
// Returns vertex count; result in `out` (capacity >= 16).
int clip_poly(const P2 *subj, int n, const P2 clip[4], P2 *out) {
  P2 buf[16];
  const P2 *in = subj;
  int nin = n;
  P2 *cur = out;
  for (int e = 0; e < 4; ++e) {
    const P2 &cp1 = clip[(e + 3) & 3];
    const P2 &cp2 = clip[e];
    int nout = 0;
    if (nin == 0) return 0;
    P2 s = in[nin - 1];
    double side_s = cross(cp1, cp2, s);
    for (int i = 0; i < nin; ++i) {
      P2 ept = in[i];
      double side_e = cross(cp1, cp2, ept);
      bool ins_e = side_e > 0.0;
      bool ins_s = side_s > 0.0;
      if (ins_e != ins_s) {
        // intersection of segment (s, ept) with the clip line
        double dcx = cp1.x - cp2.x, dcy = cp1.y - cp2.y;
        double dpx = s.x - ept.x, dpy = s.y - ept.y;
        double n1 = cp1.x * cp2.y - cp1.y * cp2.x;
        double n2 = s.x * ept.y - s.y * ept.x;
        double det = dcx * dpy - dcy * dpx;
        if (det != 0.0) {
          double inv = 1.0 / det;
          buf[nout].x = (n1 * dpx - n2 * dcx) * inv;
          buf[nout].y = (n1 * dpy - n2 * dcy) * inv;
          ++nout;
        }
      }
      if (ins_e) {
        buf[nout++] = ept;
      }
      s = ept;
      side_s = side_e;
    }
    nin = nout;
    for (int i = 0; i < nout; ++i) cur[i] = buf[i];
    in = cur;
  }
  return nin;
}

inline double shoelace(const P2 *p, int n) {
  double a = 0.0;
  for (int i = 0; i < n; ++i) {
    int j = (i + 1) % n;
    a += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  return 0.5 * std::fabs(a);
}

inline void bev_rect(const float *c, P2 out[4]) {
  // corners (8,3); BEV rect = corners 3,2,1,0 in (x, z) — CCW
  for (int i = 0; i < 4; ++i) {
    const float *v = c + 3 * (3 - i);
    out[i].x = v[0];
    out[i].y = v[2];
  }
}

inline double box_vol(const float *c) {
  auto d2 = [&](int i, int j) {
    double dx = c[3 * i] - c[3 * j];
    double dy = c[3 * i + 1] - c[3 * j + 1];
    double dz = c[3 * i + 2] - c[3 * j + 2];
    return std::sqrt(dx * dx + dy * dy + dz * dz);
  };
  return d2(0, 1) * d2(1, 2) * d2(0, 4);
}

}  // namespace

extern "C" {

// dets: (nd, 8, 3) float32; gts: (ng, 8, 3) float32; out: (nd, ng) float32
void box3d_iou_pairs(const float *dets, long nd, const float *gts, long ng,
                     float *out) {
  for (long j = 0; j < ng; ++j) {
    // precompute gt rect + vol once
    P2 rect_g[4];
    bev_rect(gts + j * 24, rect_g);
    double vol_g = box_vol(gts + j * 24);
    double ytop_g = gts[j * 24 + 0 * 3 + 1];
    double ybot_g = gts[j * 24 + 4 * 3 + 1];
    for (long i = 0; i < nd; ++i) {
      const float *d = dets + i * 24;
      P2 rect_d[4];
      bev_rect(d, rect_d);
      P2 inter[16];
      int n = clip_poly(rect_d, 4, rect_g, inter);
      double inter_area = n >= 3 ? shoelace(inter, n) : 0.0;
      double ymax = std::min((double)d[0 * 3 + 1], ytop_g);
      double ymin = std::max((double)d[4 * 3 + 1], ybot_g);
      double h = std::max(0.0, ymax - ymin);
      double iv = inter_area * h;
      double vol_d = box_vol(d);
      double denom = vol_d + vol_g - iv;
      out[i * ng + j] = denom > 0 ? (float)(iv / denom) : 0.0f;
    }
  }
}

}  // extern "C"
