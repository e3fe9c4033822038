"""Corner-based generalized 3D IoU, axis-aligned (torch counterpart of
`vdetr_tpu/geometry/iou.py:28-61,157-222`; reference
utils/box_util.py:449-624).

ScanNet's boxes are axis aligned (one angle bin), so the matcher and the
criterion of the published model take this path; the rotated
intersection (`rotated_boxes=True` in the JAX package) is not ported.
"""

from __future__ import annotations

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
    # max (the JAX package's rect[1] and rect[3] of corners [3, 2, 1, 0])
    bev1 = corners1[:, :, [2, 0]][..., [0, 2]]
    bev2 = corners2[:, :, [2, 0]][..., [0, 2]]
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
