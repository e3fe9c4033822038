"""Box parametrization and coordinate frames (torch counterpart of
`vdetr_tpu/geometry/boxes.py:20-108`; reference utils/box_util.py).

Frames:
  depth frame:  X-right, Y-forward, Z-up        (the point clouds)
  camera frame: X-right, Y-down,   Z-forward    (box corners live here)
  "lidar" frame (reference convert_corners_camera2lidar): back to depth.
"""

from __future__ import annotations

import torch

# Corner sign pattern: x uses box_size[...,0] (l), y uses box_size[...,2] (h),
# z uses box_size[...,1] (w). Reference: utils/box_util.py:271-291.
_CORNER_SIGNS_X = (1, 1, -1, -1, 1, 1, -1, -1)
_CORNER_SIGNS_Y = (1, 1, 1, 1, -1, -1, -1, -1)
_CORNER_SIGNS_Z = (1, -1, -1, 1, 1, -1, -1, 1)


def flip_axis_to_camera(pc):
    """Depth (X,Y,Z) -> camera (X,-Z,Y)."""
    return torch.stack([pc[..., 0], -pc[..., 2], pc[..., 1]], dim=-1)


def convert_corners_camera2lidar(corners):
    """Camera corners -> depth/world corners: (x, z, -y)."""
    return torch.stack([corners[..., 0], corners[..., 2], -corners[..., 1]],
                       dim=-1)


def roty_batch(t):
    """(...,) angles -> (..., 3, 3) rotation about +Y."""
    c, s = torch.cos(t), torch.sin(t)
    z = torch.zeros_like(t)
    o = torch.ones_like(t)
    return torch.stack([
        torch.stack([c, z, s], dim=-1),
        torch.stack([z, o, z], dim=-1),
        torch.stack([-s, z, c], dim=-1),
    ], dim=-2)


def get_3d_box_batch(box_size, angle, center):
    """Corners of boxes in the camera frame.

    box_size: (..., 3) (l, w, h); angle: (...,) heading about camera +Y;
    center: (..., 3) camera-frame center. Returns (..., 8, 3).
    """
    l = box_size[..., 0:1] * 0.5
    w = box_size[..., 1:2] * 0.5
    h = box_size[..., 2:3] * 0.5
    kw = dict(dtype=box_size.dtype, device=box_size.device)
    sx = torch.tensor(_CORNER_SIGNS_X, **kw)
    sy = torch.tensor(_CORNER_SIGNS_Y, **kw)
    sz = torch.tensor(_CORNER_SIGNS_Z, **kw)
    corners = torch.stack([l * sx, h * sy, w * sz], dim=-1)  # (..., 8, 3)
    R = roty_batch(angle)
    corners = (corners[..., None, :] * R[..., None, :, :]).sum(-1)
    return corners + center[..., None, :]


def box_parametrization_to_corners(center_unnorm, box_size, box_angle):
    """(center in depth frame, size, angle) -> camera-frame corners."""
    return get_3d_box_batch(box_size, box_angle,
                            flip_axis_to_camera(center_unnorm))
