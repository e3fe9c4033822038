"""Dataset configurations: numpy counterpart of
`vdetr_tpu/data/dataset_config.py` (that module imports jax through its
box helpers; this one is numpy only).

ScanNet: 18 detection classes, axis-aligned boxes (1 angle bin), per-class
mean box sizes (reference datasets/scannet.py:38-199). The synthetic
config is ScanNet's, for the generator of `data/synthetic.py`. SUN RGB-D:
10 classes, oriented boxes in 12 angle bins, per-class mean sizes
(reference datasets/sunrgbd.py); `get_dataset_config("sunrgbd")` returns
`SunrgbdDatasetConfig`.
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


class BaseDatasetConfig:
    num_semcls: int
    num_angle_bin: int
    max_num_obj: int = 64
    type2class: dict
    mean_size_arr: np.ndarray

    @property
    def class2type(self):
        return {v: k for k, v in self.type2class.items()}

    @property
    def mean_size_arr_hard_anchor(self):
        return np.ones((self.num_semcls, 3), np.float64)

    def box_parametrization_to_corners_np(self, center_unnorm, size, angle):
        center_cam = np.stack(
            [center_unnorm[..., 0], -center_unnorm[..., 2],
             center_unnorm[..., 1]], axis=-1
        )
        return _np_corners(size, angle, center_cam)

    def angle2class(self, angle):
        raise NotImplementedError

    def class2angle(self, cls, residual):
        raise NotImplementedError


class ScannetDatasetConfig(BaseDatasetConfig):
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
        self.nyu40ids = np.array(
            [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]
        )
        self.nyu40id2class = {
            int(n): i for i, n in enumerate(self.nyu40ids)
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

    def angle2class(self, angle):
        raise ValueError("ScanNet boxes are axis aligned (no angle bins)")

    def class2angle(self, cls, residual):
        return np.zeros_like(residual)

    def class2anglebatch(self, pred_cls, residual):
        return np.zeros(pred_cls.shape[0], np.float32)


class SunrgbdDatasetConfig(BaseDatasetConfig):
    def __init__(self):
        self.num_semcls = 10
        self.num_angle_bin = 12
        self.max_num_obj = 64
        self.type2class = {
            "bed": 0, "table": 1, "sofa": 2, "chair": 3, "toilet": 4,
            "desk": 5, "dresser": 6, "night_stand": 7, "bookshelf": 8,
            "bathtub": 9,
        }
        # VoteNet-lineage mean sizes
        self.mean_size_arr = np.array([
            [2.114256, 1.620300, 0.927272],
            [0.791118, 1.279516, 0.718182],
            [0.923508, 1.867419, 0.845495],
            [0.591958, 0.552978, 0.827272],
            [0.699104, 0.454178, 0.756250],
            [0.695190, 1.346299, 0.736364],
            [0.528526, 1.002642, 1.172878],
            [0.500618, 0.632163, 0.683424],
            [0.404671, 1.071108, 1.688889],
            [0.765840, 1.398258, 0.472728],
        ])

    def angle2class(self, angle):
        """Continuous angle -> (bin, residual). Bins of width 2pi/N
        centered at 0, 2pi/N, ... (VoteNet convention)."""
        num_class = self.num_angle_bin
        angle = angle % (2 * np.pi)
        angle_per_class = 2 * np.pi / num_class
        shifted = (angle + angle_per_class / 2) % (2 * np.pi)
        cls = int(shifted / angle_per_class)
        residual = shifted - (cls * angle_per_class + angle_per_class / 2)
        return cls, residual

    def class2angle(self, cls, residual, limit_period=True):
        angle_per_class = 2 * np.pi / self.num_angle_bin
        angle = cls * angle_per_class + residual
        if limit_period and angle > np.pi:
            angle -= 2 * np.pi
        return angle

    def class2anglebatch(self, pred_cls, residual):
        angle_per_class = 2 * np.pi / self.num_angle_bin
        angle = pred_cls * angle_per_class + residual
        return np.where(angle > np.pi, angle - 2 * np.pi, angle)


class SyntheticDatasetConfig(ScannetDatasetConfig):
    """ScanNet-shaped config for the synthetic data generator (tests,
    benchmarks, and smoke training without real ScanNet files)."""


def get_dataset_config(name: str) -> BaseDatasetConfig:
    if name == "scannet":
        return ScannetDatasetConfig()
    if name == "sunrgbd":
        return SunrgbdDatasetConfig()
    if name == "synthetic":
        return SyntheticDatasetConfig()
    raise ValueError(f"unknown dataset {name}")
