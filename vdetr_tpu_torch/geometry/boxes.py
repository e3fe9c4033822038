"""Box parametrization and coordinate frames (torch counterpart of
`vdetr_tpu/geometry/boxes.py:20-108`; reference utils/box_util.py), and
the data pipeline's numpy rotation of axis-aligned boxes
(`rotate_aligned_boxes_np`, a copy of that module's :133).

Frames:
  depth frame:  X-right, Y-forward, Z-up        (the point clouds)
  camera frame: X-right, Y-down,   Z-forward    (box corners live here)
  "lidar" frame (reference convert_corners_camera2lidar): back to depth.
"""

from __future__ import annotations

import numpy as np
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


def rotate_aligned_boxes_np(input_boxes: np.ndarray, rot_mat: np.ndarray):
    """Rotate axis-aligned (cx,cy,cz,dx,dy,dz) boxes; keep them axis aligned
    by taking the rotated-corner extents. numpy (data pipeline).

    Reference: datasets/scannet.py:178-199.
    """
    centers, lengths = input_boxes[:, 0:3], input_boxes[:, 3:6]
    new_centers = centers @ rot_mat.T
    dx, dy = lengths[:, 0] / 2.0, lengths[:, 1] / 2.0
    corners = np.stack(
        [
            np.stack([sx * dx, sy * dy, np.zeros_like(dx)], axis=1)
            for sx, sy in [(-1, -1), (1, -1), (1, 1), (-1, 1)]
        ],
        axis=1,
    )  # (N, 4, 3)
    crnrs = corners @ rot_mat.T
    new_dx = 2.0 * crnrs[..., 0].max(axis=1)
    new_dy = 2.0 * crnrs[..., 1].max(axis=1)
    new_lengths = np.stack([new_dx, new_dy, lengths[:, 2]], axis=1)
    return np.concatenate([new_centers, new_lengths], axis=1)
