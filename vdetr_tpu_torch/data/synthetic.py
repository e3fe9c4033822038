"""Synthetic indoor scenes: a numpy copy of `vdetr_tpu/data/synthetic.py`
(whose dataset-config import pulls in jax). For the same seed and index
it produces identical arrays. Boxes are axis aligned, as in ScanNet; the
rotated scenes of an angle-binned dataset are not ported.

Scenes are rooms with box-shaped objects whose sizes are drawn around the
per-class mean sizes; points are sampled on object surfaces plus
floor/wall clutter at ~1 cm density, like a real ScanNet scan.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from vdetr_tpu_torch.data.loader import prefetch_loader


class SyntheticDetectionDataset:
    def __init__(self, dataset_config, num_points: int,
                 num_scenes: int = 64, min_objects: int = 3,
                 max_objects: int = 10, seed: int = 0):
        self.ds = dataset_config
        self.num_points = num_points
        self.num_scenes = num_scenes
        self.min_objects = min_objects
        self.max_objects = max_objects
        self.seed = seed

    def __len__(self):
        return self.num_scenes

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        ds = self.ds
        K = ds.max_num_obj
        room = rng.rand(2) * 3 + 4.0  # 4-7m footprint
        height = 2.5 + rng.rand() * 0.7

        n_obj = rng.randint(self.min_objects, self.max_objects + 1)
        centers = np.zeros((K, 3), np.float32)
        sizes = np.zeros((K, 3), np.float32)
        angles = np.zeros((K,), np.float32)
        labels = np.zeros((K,), np.int64)
        present = np.zeros((K,), np.float32)

        pts_parts = []
        for i in range(n_obj):
            cls = rng.randint(ds.num_semcls)
            mean = ds.mean_size_arr[cls]
            size = (mean * np.exp(rng.randn(3) * 0.1)).astype(np.float32)
            size = np.clip(size, 0.1, None)
            cx = rng.rand() * (room[0] - size[0]) + size[0] / 2
            cy = rng.rand() * (room[1] - size[1]) + size[1] / 2
            cz = size[2] / 2
            centers[i] = (cx, cy, cz)
            sizes[i] = size
            labels[i] = cls
            present[i] = 1.0
            # surface points at ~cm density (a real scan has ~50-80k
            # distinct 1 cm voxels per scene)
            area = 2 * (size[0] * size[1] + size[0] * size[2]
                        + size[1] * size[2])
            npts = int(np.clip(area / 2e-4, 400, 20000))
            face = rng.randint(0, 6, npts)
            u = rng.rand(npts, 3) - 0.5
            for ax in range(3):
                sel = face // 2 == ax
                u[sel, ax] = 0.5 * np.sign(face[sel] % 2 - 0.5)
            pts_parts.append(u * size + centers[i])

        # floor + wall clutter at the same ~cm surface density
        nfloor = int(np.clip(room[0] * room[1] / 2e-4, 2000, 40000))
        floor = np.stack(
            [rng.rand(nfloor) * room[0], rng.rand(nfloor) * room[1],
             np.abs(rng.randn(nfloor)) * 0.01], axis=1
        )
        nwall = int(np.clip(room[0] * height / 2e-4, 1000, 20000))
        wall = np.stack(
            [rng.rand(nwall) * room[0], np.zeros(nwall) + 0.01,
             rng.rand(nwall) * height], axis=1
        )
        pts = np.concatenate(pts_parts + [floor, wall]).astype(np.float32)
        # resample to fixed count
        choice = rng.choice(len(pts), self.num_points,
                            replace=len(pts) < self.num_points)
        point_cloud = pts[choice]

        dmin = point_cloud.min(0)
        dmax = point_cloud.max(0)
        scene = np.maximum(dmax - dmin, 1e-3)
        centers_norm = (centers - dmin) / scene * present[:, None]
        sizes_norm = sizes / scene
        corners = self.ds.box_parametrization_to_corners_np(
            centers, sizes, angles
        )

        return {
            "point_clouds": point_cloud.astype(np.float32),
            "point_validity": np.ones((self.num_points,), bool),
            "gt_box_corners": corners.astype(np.float32),
            "gt_box_centers": centers,
            "gt_box_centers_normalized": centers_norm.astype(np.float32),
            "gt_box_sizes": sizes,
            "gt_box_sizes_normalized": sizes_norm.astype(np.float32),
            "gt_box_angles": angles,
            "gt_angle_class_label": np.zeros((K,), np.int64),
            "gt_angle_residual_label": np.zeros((K,), np.float32),
            "gt_box_sem_cls_label": labels,
            "gt_box_present": present,
            "scan_idx": np.int64(idx),
            "point_cloud_dims_min": dmin.astype(np.float32),
            "point_cloud_dims_max": dmax.astype(np.float32),
        }


def collate(samples) -> Dict[str, np.ndarray]:
    """Plain stacking (reference datasets/scannet.py:652-660)."""
    out = {}
    for k in samples[0]:
        out[k] = np.stack([s[k] for s in samples])
    return out


def make_loader(dataset, batch_size: int, shuffle: bool = True,
                seed: int = 0, drop_last: bool = True,
                pad_last: bool = False) -> Iterator:
    """pad_last=True keeps the batch shape static without dropping tail
    scans: the final partial batch is padded by repeating its last sample
    and every batch carries a per-sample `sample_valid` mask, which the AP
    calculator reads (the reference evaluates every scan at bs=1,
    engine.py:125-192; dropping the tail would bias mAP whenever len(val)
    % batch != 0). The batches of `vdetr_tpu/data/synthetic.py:make_loader`,
    from `data/loader.py:prefetch_loader` without threads."""
    return prefetch_loader(dataset, batch_size, shuffle, seed, drop_last,
                           pad_last, num_workers=0)
