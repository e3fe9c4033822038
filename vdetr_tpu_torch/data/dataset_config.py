"""ScanNet dataset configuration: numpy counterpart of the ScanNet part of
`vdetr_tpu/data/dataset_config.py` (that module imports jax through its
box helpers; this one is numpy only).

18 detection classes, axis-aligned boxes (1 angle bin), per-class mean
box sizes (reference datasets/scannet.py:38-199).
"""

from __future__ import annotations

import numpy as np


def _np_corners(box_size, angle, center):
    """numpy corner construction matching geometry.boxes.get_3d_box_batch."""
    sx = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64)
    sy = np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float64)
    sz = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64)
    l = box_size[..., 0:1] * 0.5
    w = box_size[..., 1:2] * 0.5
    h = box_size[..., 2:3] * 0.5
    corners = np.stack([l * sx, h * sy, w * sz], axis=-1)
    c, s = np.cos(angle), np.sin(angle)
    zeros = np.zeros_like(c)
    ones = np.ones_like(c)
    R = np.stack(
        [
            np.stack([c, zeros, s], axis=-1),
            np.stack([zeros, ones, zeros], axis=-1),
            np.stack([-s, zeros, c], axis=-1),
        ],
        axis=-2,
    )
    corners = (corners[..., None, :] * R[..., None, :, :]).sum(-1)
    return (corners + center[..., None, :]).astype(np.float32)


class ScannetDatasetConfig:
    def __init__(self):
        self.num_semcls = 18
        self.num_angle_bin = 1
        self.max_num_obj = 64
        self.type2class = {
            "cabinet": 0, "bed": 1, "chair": 2, "sofa": 3, "table": 4,
            "door": 5, "window": 6, "bookshelf": 7, "picture": 8,
            "counter": 9, "desk": 10, "curtain": 11, "refrigerator": 12,
            "showercurtrain": 13, "toilet": 14, "sink": 15, "bathtub": 16,
            "garbagebin": 17,
        }
        # per-class mean box sizes (dataset statistics,
        # reference datasets/scannet.py:72-91)
        self.mean_size_arr = np.array([
            [0.76966727, 0.8116021, 0.92573744],
            [1.876858, 1.8425595, 1.1931566],
            [0.61328, 0.6148609, 0.7182701],
            [1.3955007, 1.5121545, 0.83443564],
            [0.97949594, 1.0675149, 0.6329687],
            [0.531663, 0.5955577, 1.7500148],
            [0.9624706, 0.72462326, 1.1481868],
            [0.83221924, 1.0490936, 1.6875663],
            [0.21132214, 0.4206159, 0.5372846],
            [1.4440073, 1.8970833, 0.26985747],
            [1.0294262, 1.4040797, 0.87554324],
            [1.3766412, 0.65521795, 1.6813129],
            [0.6650819, 0.71111923, 1.298853],
            [0.41999173, 0.37906948, 1.7513971],
            [0.59359556, 0.5912492, 0.73919016],
            [0.50867593, 0.50656086, 0.30136237],
            [1.1511526, 1.0546296, 0.49706793],
            [0.47535285, 0.49249494, 0.5802117],
        ])

    @property
    def class2type(self):
        return {v: k for k, v in self.type2class.items()}

    def box_parametrization_to_corners_np(self, center_unnorm, size, angle):
        center_cam = np.stack(
            [center_unnorm[..., 0], -center_unnorm[..., 2],
             center_unnorm[..., 1]], axis=-1
        )
        return _np_corners(size, angle, center_cam)
