"""SUN RGB-D detection dataset (oriented boxes, 12 angle bins), a numpy
copy of `vdetr_tpu/data/sunrgbd.py`: from the same
`np.random.RandomState` it gives the same sample, bit for bit.

The reference advertises SUN RGB-D but ships no loader
(datasets/__init__.py:2); this completes that surface following the
standard VoteNet/3DETR data contract: per-sample
`<id>_pc.npz` (point cloud, (N, 6) xyz+rgb) and `<id>_bbox.npy`
((K, 8): cx cy cz dx dy dz heading cls).

Augmentations (3DETR-style for oriented boxes): YZ-plane flip (negate x
and heading), +-30 deg z-rotation, 0.85-1.15 uniform scale. The val
split's fixed-count subsample is drawn from `np.random.RandomState(idx)`:
an eval pass is repeatable (`--test_only` reproduces a training run's
eval); the JAX loader draws it from the caller's generator, unseeded by
default.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.data.dataset_config import SunrgbdDatasetConfig
from vdetr_tpu_torch.data.scannet import random_sampling, rotz


class SunrgbdDetectionDataset:
    def __init__(self, cfg: VDETRConfig,
                 dataset_config: Optional[SunrgbdDatasetConfig] = None,
                 split_set: str = "train", augment: Optional[bool] = None):
        self.cfg = cfg
        self.ds = dataset_config or SunrgbdDatasetConfig()
        root = cfg.dataset_root_dir
        if root is None:
            raise ValueError("dataset_root_dir required for sunrgbd")
        self.data_path = os.path.join(root, split_set)
        self.augment = augment if augment is not None else split_set == "train"
        self.sample_ids = sorted({
            f.split("_")[0] for f in os.listdir(self.data_path)
            if f.endswith("_bbox.npy")
        })

    def __len__(self):
        return len(self.sample_ids)

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Dict[str, np.ndarray]:
        rng = rng or np.random.RandomState()
        cfg, ds = self.cfg, self.ds
        sid = self.sample_ids[idx]
        pc = np.load(os.path.join(self.data_path, f"{sid}_pc.npz"))["pc"]
        bboxes = np.load(os.path.join(self.data_path, f"{sid}_bbox.npy"))

        if not cfg.use_color:
            pc = pc[:, 0:3]
        pc = pc.copy().astype(np.float32)

        centers = bboxes[:, 0:3].copy()
        sizes = bboxes[:, 3:6].copy()
        angles = bboxes[:, 6].copy()
        classes = bboxes[:, 7].astype(np.int64)

        if self.augment:
            if rng.rand() > 0.5:  # flip x
                pc[:, 0] = -pc[:, 0]
                centers[:, 0] = -centers[:, 0]
                angles = np.pi - angles
            rot = (rng.rand() * np.pi / 3) - np.pi / 6  # +-30 deg
            mat = rotz(rot)
            pc[:, 0:3] = pc[:, 0:3] @ mat.T
            centers = centers @ mat.T
            angles = angles - rot
            s = 0.85 + rng.rand() * 0.3
            pc[:, 0:3] *= s
            centers *= s
            sizes *= s
            if cfg.coloraug_sunrgbd and cfg.use_color:
                # brightness / shift / per-point jitter / 30% color dropout
                # on centered [-0.5, 0.5] colors (reference
                # datasets/scannet.py:544-560)
                rgb = pc[:, 3:6]
                rgb += 0.5
                rgb *= 1 + 0.4 * rng.random_sample(3) - 0.2
                rgb += 0.1 * rng.random_sample(3) - 0.05
                rgb += (0.05 * rng.random_sample(len(pc)) - 0.025)[:, None]
                rgb[:] = np.clip(rgb, 0, 1)
                rgb *= (rng.random_sample(len(pc)) > 0.3)[:, None]
                rgb -= 0.5
        angles = np.mod(angles + np.pi, 2 * np.pi) - np.pi

        # the val split draws its subsample from the scan's index, as the
        # ScanNet loader does (data/scannet.py), so that every eval pass
        # sees the same points (the JAX loader draws it unseeded here)
        pc, _ = random_sampling(
            pc, cfg.num_points,
            rng if self.augment else np.random.RandomState(idx),
            return_choices=True)

        K = ds.max_num_obj
        nb = min(len(bboxes), K)
        gt_centers = np.zeros((K, 3), np.float32)
        gt_sizes = np.zeros((K, 3), np.float32)
        gt_angles = np.zeros((K,), np.float32)
        labels = np.zeros((K,), np.int64)
        present = np.zeros((K,), np.float32)
        angle_cls = np.zeros((K,), np.int64)
        angle_res = np.zeros((K,), np.float32)
        gt_centers[:nb] = centers[:nb]
        gt_sizes[:nb] = sizes[:nb]
        gt_angles[:nb] = angles[:nb]
        labels[:nb] = classes[:nb]
        present[:nb] = 1
        for i in range(nb):
            c, r = ds.angle2class(gt_angles[i])
            angle_cls[i], angle_res[i] = c, r

        dims_min = pc[:, 0:3].min(0).astype(np.float32)
        dims_max = pc[:, 0:3].max(0).astype(np.float32)
        scene = np.maximum(dims_max - dims_min, 1e-3)
        centers_norm = ((gt_centers - dims_min) / scene) * present[:, None]
        sizes_norm = gt_sizes / scene
        corners = ds.box_parametrization_to_corners_np(
            gt_centers, gt_sizes, gt_angles
        )

        return {
            "point_clouds": pc.astype(np.float32),
            "point_validity": np.ones((cfg.num_points,), bool),
            "gt_box_corners": corners.astype(np.float32),
            "gt_box_centers": gt_centers,
            "gt_box_centers_normalized": centers_norm.astype(np.float32),
            "gt_box_sizes": gt_sizes,
            "gt_box_sizes_normalized": sizes_norm.astype(np.float32),
            "gt_box_angles": gt_angles,
            "gt_angle_class_label": angle_cls,
            "gt_angle_residual_label": angle_res,
            "gt_box_sem_cls_label": labels,
            "gt_box_present": present,
            "scan_idx": np.int64(idx),
            "point_cloud_dims_min": dims_min,
            "point_cloud_dims_max": dims_max,
        }
