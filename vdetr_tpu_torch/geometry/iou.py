"""Corner-based generalized 3D IoU, axis-aligned (torch counterpart of
`vdetr_tpu/geometry/iou.py:28-61,157-222`; reference
utils/box_util.py:449-624), and the exact rotated IoU in numpy that the
AP evaluator scores with (`box3d_iou_np`).

ScanNet's boxes are axis aligned (one angle bin), so the matcher and the
criterion of the published model take the torch path; the rotated
intersection of the criterion (`rotated_boxes=True` in the JAX package)
is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

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


def generalized_box3d_iou(corners1, corners2, nums_k2=None):
    """GIoU matrix (B, K1, K2) of axis-aligned boxes given by camera-frame
    corners (Y down): corners1 (B, K1, 8, 3) predictions, corners2 (B, K2,
    8, 3) ground truth; nums_k2 (B,) zeroes the GT columns past each
    count."""
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
    inter_vols = inter_areas * height
    union_vols = (sum_vols - inter_vols).clamp(min=EPS)
    gious = inter_vols / union_vols - (1.0 - union_vols / enclosing)
    gious = gious * good
    if nums_k2 is not None:
        gious = gious * k2_mask[:, None, :]
    return gious


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
