"""3D IoU / GIoU math (torch counterpart of `vdetr_tpu/geometry/iou.py`;
reference utils/box_util.py:449-624, criterion.py:25-70).

- `generalized_box3d_iou`: the corner-based GIoU of the matcher and the
  criterion. Axis-aligned (ScanNet: one angle bin) it is torch ops;
  with `rotated_boxes` (an angle-binned dataset, SUN RGB-D) the bird's-eye
  intersection of each pair is the Sutherland-Hodgman clip of
  `rotated_intersection_areas`: kernel R (`ops/rotated_iou.py`,
  `csrc/rotated_iou.cu`) on the card, its plain version
  (`clip_quad_quad_plain`, JAX's `_clip_quad_quad` vectorized over the
  pairs) on the CPU.
- `diff_iou_rotated_3d`, `diff_diou_rotated_3d`: the differentiable
  rotated IoU and DIoU of paired boxes (the criterion's `iou_type` "iou"
  and "diou"; mmcv's diff_iou_rotated re-expressed), plain torch.
- `box3d_iou_np`: the exact rotated IoU in numpy that the AP evaluator
  scores with, on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from vdetr_tpu_torch.ops.rotated_iou import rotated_intersection_areas

EPS = 1e-8
VOL_EPS = 1e-6


def box3d_vol_corners(corners):
    """(..., 8, 3) corners -> (...,) volume as the product of three edge
    lengths (squared lengths clamped at 1e-6, as the reference does)."""
    def edge(i, j):
        d2 = ((corners[..., i, :] - corners[..., j, :]) ** 2).sum(-1)
        return torch.sqrt(d2.clamp(min=VOL_EPS))
    return edge(0, 1) * edge(1, 2) * edge(0, 4)


def enclosing_box3d_vol(corners1, corners2):
    """Volume of the axis-aligned box enclosing each pair: corners1 (B,
    K1, 8, 3), corners2 (B, K2, 8, 3) -> (B, K1, K2)."""
    mn1, mx1 = corners1.min(dim=2).values, corners1.max(dim=2).values
    mn2, mx2 = corners2.min(dim=2).values, corners2.max(dim=2).values
    lo = torch.minimum(mn1[:, :, None, :], mn2[:, None, :, :])
    hi = torch.maximum(mx1[:, :, None, :], mx2[:, None, :, :])
    d = (hi - lo).abs()
    return d[..., 0] * d[..., 1] * d[..., 2]


def _bev_rects(corners):
    """Camera-frame corners (..., 8, 3) -> bird's-eye rects (..., 4, 2) in
    (x, z): corners 3, 2, 1, 0 (reference utils/box_util.py:555-560), by
    flip and slice (an index list would be a copy to the device)."""
    return corners[..., :4, :].flip(-2)[..., ::2]


def generalized_box3d_iou(corners1, corners2, nums_k2=None,
                          rotated_boxes: bool = False,
                          return_inter_vols_only: bool = False):
    """GIoU matrix (B, K1, K2) of boxes given by camera-frame corners (Y
    down): corners1 (B, K1, 8, 3) predictions, corners2 (B, K2, 8, 3)
    ground truth; nums_k2 (B,) zeroes the GT columns past each count.
    `rotated_boxes`: the bird's-eye intersection is the clip of the two
    rects (kernel R on the card), taken only where the rects' corners 1
    and 3 overlap as an axis-aligned box (the reference skips the other
    pairs: a rotated pair may overlap and still be skipped).
    `return_inter_vols_only`: the (B, K1, K2) intersection volumes."""
    K2 = corners2.shape[1]
    # height overlap along camera Y (corner 0 top, corner 4 bottom)
    ymax = torch.minimum(corners1[:, :, 0, 1][:, :, None],
                         corners2[:, :, 0, 1][:, None, :])
    ymin = torch.maximum(corners1[:, :, 4, 1][:, :, None],
                         corners2[:, :, 4, 1][:, None, :])
    height = (ymax - ymin).clamp(min=0.0)
    # bird's-eye (x, z) extents: corner 2 is the min corner, corner 0 the
    # max (the JAX package's rect[1] and rect[3] of corners [3, 2, 1, 0]);
    # taken by slicing: an index list would be copied to the device, a
    # synchronizing copy on the card
    bev1 = torch.stack([corners1[:, :, 2], corners1[:, :, 0]], 2)[..., ::2]
    bev2 = torch.stack([corners2[:, :, 2], corners2[:, :, 0]], 2)[..., ::2]
    lt = torch.maximum(bev1[:, :, None, 0, :], bev2[:, None, :, 0, :])
    rb = torch.minimum(bev1[:, :, None, 1, :], bev2[:, None, :, 1, :])
    wh = (rb - lt).clamp(min=0.0)
    inter_areas = wh[..., 0] * wh[..., 1]
    if nums_k2 is not None:
        k2_mask = (torch.arange(K2, device=corners2.device)[None, :]
                   < nums_k2[:, None])
        inter_areas = inter_areas * k2_mask[:, None, :]
    enclosing = enclosing_box3d_vol(corners1, corners2)
    vols1 = box3d_vol_corners(corners1).clamp(min=EPS)
    vols2 = box3d_vol_corners(corners2).clamp(min=EPS)
    sum_vols = vols1[:, :, None] + vols2[:, None, :]
    good = (enclosing > 2 * EPS) & (sum_vols > 4 * EPS)
    if rotated_boxes:
        inter_areas = rotated_intersection_areas(
            _bev_rects(corners1), _bev_rects(corners2), inter_areas > 0)
    inter_vols = inter_areas * height
    if return_inter_vols_only:
        return inter_vols
    union_vols = (sum_vols - inter_vols).clamp(min=EPS)
    gious = inter_vols / union_vols - (1.0 - union_vols / enclosing)
    # a select, as XLA compiles JAX's multiply by the mask: two zero-volume
    # boxes (enclosing volume 0) give 0, not inf * 0
    gious = torch.where(good, gious, 0.0)
    if nums_k2 is not None:
        gious = gious * k2_mask[:, None, :]
    return gious


# --------------------------------------------------------------------------
# Differentiable rotated IoU of paired boxes (`vdetr_tpu/geometry/iou.py:
# 225-360`, mmcv diff_iou_rotated_3d re-expressed), plain torch
# --------------------------------------------------------------------------

def box2corners_bev(box5):
    """(..., 5) (x, y, w, h, alpha) -> (..., 4, 2) BEV corners."""
    x, y, w, h, a = box5.unbind(-1)
    sx = torch.tensor([0.5, -0.5, -0.5, 0.5], dtype=box5.dtype,
                      device=box5.device)
    sy = torch.tensor([-0.5, -0.5, 0.5, 0.5], dtype=box5.dtype,
                      device=box5.device)
    cx = w[..., None] * sx
    cy = h[..., None] * sy
    c, s = torch.cos(a)[..., None], torch.sin(a)[..., None]
    rx = cx * c - cy * s + x[..., None]
    ry = cx * s + cy * c + y[..., None]
    return torch.stack([rx, ry], dim=-1)


def _convex_area_from_candidates(pts, mask):
    """Area of the convex polygon through the masked candidate points:
    pts (N, P, 2), mask (N, P) bool -> (N,). Sorts the valid points by
    angle around their mean (stably, invalid ones last at 1e9, as
    `jnp.argsort` does) and applies the shoelace formula."""
    mf = mask.to(pts.dtype)
    num = mf.sum(-1).clamp(min=1)
    mean = (pts * mf[..., None]).sum(-2) / num[..., None]
    d = pts - mean[..., None, :]
    ang = torch.atan2(d[..., 1], d[..., 0])
    ang = torch.where(mask, ang, 1e9)
    order = torch.argsort(ang, dim=-1, stable=True)
    p = pts.gather(-2, order[..., None].expand(pts.shape))
    m = mask.gather(-1, order)
    n = mask.sum(-1)
    idx = torch.arange(pts.shape[-2], device=pts.device)
    nxt = torch.where(idx + 1 < n[..., None], idx + 1, 0)
    x, y = p[..., 0], p[..., 1]
    contrib = torch.where(m, x * y.gather(-1, nxt) - y * x.gather(-1, nxt),
                          0.0)
    area = 0.5 * contrib.sum(-1).abs()
    return torch.where(n >= 3, area, 0.0)


def _pair_intersection_area(c1, c2):
    """Intersection areas of convex quads c1, c2: (N, 4, 2) each -> (N,).
    Candidates: the corners of each quad inside the other (a point is
    inside when its cross products with the edges share a sign, 1e-9
    slack) and the 16 edge-pair intersections."""
    def inside_quad(p, quad):
        a = quad[:, None, :, :]
        b = torch.roll(quad, -1, dims=1)[:, None, :, :]
        pp = p[:, :, None, :]
        cross = ((b[..., 0] - a[..., 0]) * (pp[..., 1] - a[..., 1])
                 - (b[..., 1] - a[..., 1]) * (pp[..., 0] - a[..., 0]))
        return (cross >= -1e-9).all(-1) | (cross <= 1e-9).all(-1)

    in12 = inside_quad(c1, c2)
    in21 = inside_quad(c2, c1)
    # edge i of c1 against edge j of c2, i-major
    p1 = c1[:, :, None, :]
    p2 = torch.roll(c1, -1, dims=1)[:, :, None, :]
    p3 = c2[:, None, :, :]
    p4 = torch.roll(c2, -1, dims=1)[:, None, :, :]
    d1 = p2 - p1
    d2 = p4 - p3
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    r = p3 - p1
    # a parallel pair's point is never a candidate: its denominator is 1
    # (JAX divides by denom + 1e-30 there, and its gradient is then NaN,
    # 0 * inf; the forward is the same)
    skew = denom.abs() > 1e-12
    den = torch.where(skew, denom + 1e-30, 1.0)
    t = (r[..., 0] * d2[..., 1] - r[..., 1] * d2[..., 0]) / den
    u = (r[..., 0] * d1[..., 1] - r[..., 1] * d1[..., 0]) / den
    ok = skew & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    ipts = (p1 + t[..., None] * d1).reshape(-1, 16, 2)
    pts = torch.cat([c1, c2, ipts], dim=1)  # (N, 24, 2)
    mask = torch.cat([in12, in21, ok.reshape(-1, 16)], dim=1)
    return _convex_area_from_candidates(pts, mask)


def oriented_box_intersection_2d(corners1, corners2):
    """(..., 4, 2) x (..., 4, 2) -> (...,) intersection areas."""
    areas = _pair_intersection_area(corners1.reshape(-1, 4, 2),
                                    corners2.reshape(-1, 4, 2))
    return areas.reshape(corners1.shape[:-2])


def _xywha(box3d):
    """(..., 7) (x, y, z, dx, dy, dz, yaw) -> (..., 5) (x, y, dx, dy,
    yaw), by slices."""
    return torch.cat([box3d[..., 0:2], box3d[..., 3:5], box3d[..., 6:7]],
                     dim=-1)


def _z_range(box3d):
    half = box3d[..., 5] * 0.5
    return box3d[..., 2] + half, box3d[..., 2] - half


def diff_iou_rotated_3d(box3d1, box3d2):
    """Differentiable rotated 3D IoU of paired boxes (..., 7): (x, y,
    z_center, dx, dy, dz, yaw). Reference semantics:
    mmcv.ops.diff_iou_rotated_3d as used at criterion.py:627-628."""
    corners1 = box2corners_bev(_xywha(box3d1))
    corners2 = box2corners_bev(_xywha(box3d2))
    inter = oriented_box_intersection_2d(corners1, corners2)
    zmax1, zmin1 = _z_range(box3d1)
    zmax2, zmin2 = _z_range(box3d2)
    z_overlap = (torch.minimum(zmax1, zmax2)
                 - torch.maximum(zmin1, zmin2)).clamp(min=0.0)
    inter3d = inter * z_overlap
    vol1 = box3d1[..., 3] * box3d1[..., 4] * box3d1[..., 5]
    vol2 = box3d2[..., 3] * box3d2[..., 4] * box3d2[..., 5]
    union3d = vol1 + vol2 - inter3d
    return inter3d / union3d.clamp(min=1e-8)


def diff_diou_rotated_3d(box3d1, box3d2):
    """Differentiable rotated 3D DIoU. Reference: criterion.py:25-70."""
    iou = diff_iou_rotated_3d(box3d1, box3d2)
    box1, box2 = _xywha(box3d1), _xywha(box3d2)
    corners1 = box2corners_bev(box1)
    corners2 = box2corners_bev(box2)
    zmax1, zmin1 = _z_range(box3d1)
    zmax2, zmin2 = _z_range(box3d2)
    x_max = torch.maximum(corners1[..., 0].amax(-1),
                          corners2[..., 0].amax(-1))
    x_min = torch.minimum(corners1[..., 0].amin(-1),
                          corners2[..., 0].amin(-1))
    y_max = torch.maximum(corners1[..., 1].amax(-1),
                          corners2[..., 1].amax(-1))
    y_min = torch.minimum(corners1[..., 1].amin(-1),
                          corners2[..., 1].amin(-1))
    z_max = torch.maximum(zmax1, zmax2)
    z_min = torch.minimum(zmin1, zmin2)
    # the reference's quirk (criterion.py:67): the centre distance over
    # (x, y, w), box1[..., :3] of the 5-tuple (x, y, w, h, a)
    r2 = ((box1[..., :3] - box2[..., :3]) ** 2).sum(-1)
    c2 = (x_min - x_max) ** 2 + (y_min - y_max) ** 2 + (z_min - z_max) ** 2
    return iou - r2 / c2.clamp(min=1e-8)


# --------------------------------------------------------------------------
# Exact rotated IoU for the AP evaluator, in numpy on the host (a copy of
# `vdetr_tpu/geometry/iou.py:367-438`; reference utils/box_util.py:37-147)
# --------------------------------------------------------------------------

def _polygon_clip_np(subject, clip):
    """Sutherland-Hodgman in numpy; subject/clip lists of (x, y), clip CCW.

    Returns vertex list or None. Mirrors utils/box_util.py:37-84.
    """
    def inside(p, cp1, cp2):
        return (cp2[0] - cp1[0]) * (p[1] - cp1[1]) > (cp2[1] - cp1[1]) * (
            p[0] - cp1[0]
        )

    def intersection(cp1, cp2, s, e):
        dc = (cp1[0] - cp2[0], cp1[1] - cp2[1])
        dp = (s[0] - e[0], s[1] - e[1])
        n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
        n2 = s[0] * e[1] - s[1] * e[0]
        n3 = 1.0 / (dc[0] * dp[1] - dc[1] * dp[0])
        return ((n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3)

    output = list(subject)
    cp1 = clip[-1]
    for cp2 in clip:
        inp = output
        output = []
        if not inp:
            return None
        s = inp[-1]
        for e in inp:
            if inside(e, cp1, cp2):
                if not inside(s, cp1, cp2):
                    output.append(intersection(cp1, cp2, s, e))
                output.append(e)
            elif inside(s, cp1, cp2):
                output.append(intersection(cp1, cp2, s, e))
            s = e
        cp1 = cp2
        if not output:
            return None
    return output


def _poly_area_np(pts):
    x = np.array([p[0] for p in pts])
    y = np.array([p[1] for p in pts])
    return 0.5 * np.abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def box3d_iou_np(corners1: np.ndarray, corners2: np.ndarray):
    """Exact rotated 3D IoU of two camera-frame corner boxes (8, 3).

    Reference: utils/box_util.py:122-147 (up direction is negative Y).
    Returns (iou3d, iou2d).
    """
    rect1 = [(corners1[i, 0], corners1[i, 2]) for i in range(3, -1, -1)]
    rect2 = [(corners2[i, 0], corners2[i, 2]) for i in range(3, -1, -1)]
    area1 = _poly_area_np(rect1)
    area2 = _poly_area_np(rect2)
    inter = _polygon_clip_np(rect1, rect2)
    inter_area = _poly_area_np(inter) if inter else 0.0
    iou_2d = inter_area / (area1 + area2 - inter_area)
    ymax = min(corners1[0, 1], corners2[0, 1])
    ymin = max(corners1[4, 1], corners2[4, 1])
    inter_vol = inter_area * max(0.0, ymax - ymin)

    def vol(c):
        a = np.sqrt(((c[0] - c[1]) ** 2).sum())
        b = np.sqrt(((c[1] - c[2]) ** 2).sum())
        h = np.sqrt(((c[0] - c[4]) ** 2).sum())
        return a * b * h

    v1, v2 = vol(corners1), vol(corners2)
    iou = inter_vol / (v1 + v2 - inter_vol)
    return iou, iou_2d
