"""Points inside yawed boxes (torch counterpart of
`vdetr_tpu/geometry/points_in_boxes.py`; replaces
mmcv.ops.points_in_boxes_all, reference criterion.py:279).

Boxes are (cx, cy, cz_bottom, dx, dy, dz, yaw) with yaw about +Z; a point
is inside when its box-local coordinates satisfy |lx| < dx/2, |ly| <
dy/2 and 0 <= lz <= dz.
"""

from __future__ import annotations

import torch


def points_in_boxes_all(points, boxes):
    """points (B, N, 3), boxes (B, T, 7) -> (B, N, T) float 0/1."""
    center, dims, yaw = boxes[..., 0:3], boxes[..., 3:6], boxes[..., 6]
    d = points[:, :, None, :] - center[:, None, :, :]      # (B, N, T, 3)
    c = torch.cos(-yaw)[:, None, :]
    s = torch.sin(-yaw)[:, None, :]
    lx = d[..., 0] * c - d[..., 1] * s
    ly = d[..., 0] * s + d[..., 1] * c
    lz = d[..., 2]
    inside = ((lx.abs() < dims[:, None, :, 0] * 0.5)
              & (ly.abs() < dims[:, None, :, 1] * 0.5)
              & (lz >= 0.0) & (lz <= dims[:, None, :, 2]))
    return inside.float()
