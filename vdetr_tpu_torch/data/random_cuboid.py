"""RandomCuboid crop augmentation (reference utils/random_cuboid.py:38-98),
a copy of `vdetr_tpu/data/random_cuboid.py`: the same draws from the same
`np.random.RandomState` give the same crop.

Up to 100 tries to find a crop covering 50-100% of the xy-range with
aspect >= 0.8 that keeps >= min_points points and at least one box center;
falls back to the full scene.
"""

from __future__ import annotations

import numpy as np


def _check_aspect(crop_range, aspect_min):
    xy = crop_range[[0, 1]]
    xz = crop_range[[0, 2]]
    yz = crop_range[[1, 2]]
    return (
        (xy.min() / xy.max()) >= aspect_min
        or (xz.min() / xz.max()) >= aspect_min
        or (yz.min() / yz.max()) >= aspect_min
    )


class RandomCuboid:
    def __init__(self, min_points: int, aspect: float = 0.8,
                 min_crop: float = 0.5, max_crop: float = 1.0):
        self.min_points = min_points
        self.aspect = aspect
        self.min_crop = min_crop
        self.max_crop = max_crop

    def __call__(self, point_cloud, target_boxes, per_point_labels=None,
                 rng: np.random.RandomState = None):
        rng = rng or np.random
        # contiguous per-axis copies: every try's range test then runs on
        # contiguous 1-D arrays instead of strided (N, 3) views (the mask
        # was ~25% of the per-item loader time, tools/loader_bench.py)
        xs = np.ascontiguousarray(point_cloud[:, 0])
        ys = np.ascontiguousarray(point_cloud[:, 1])
        zs = np.ascontiguousarray(point_cloud[:, 2])
        mins = np.array([xs.min(), ys.min(), zs.min()])
        maxs = np.array([xs.max(), ys.max(), zs.max()])
        range_xyz = maxs - mins
        have_boxes = target_boxes is not None and len(target_boxes) > 0
        if have_boxes:
            centers = target_boxes[:, 0:3]
        for _ in range(100):
            crop = (
                self.min_crop
                + rng.rand(3) * (self.max_crop - self.min_crop)
            )
            if not _check_aspect(crop, self.aspect):
                continue
            sample_center = (
                point_cloud[rng.randint(len(point_cloud)), 0:3]
            )
            new_range = range_xyz * crop / 2.0
            lo = sample_center - new_range
            hi = sample_center + new_range
            # the try is accepted iff BOTH the point-count and the
            # box-center conditions hold; testing the (<=64-row) box
            # condition first skips the expensive full-cloud mask on
            # box-rejected tries without changing any rng draw or the
            # accept/reject sequence
            if have_boxes:
                box_keep = np.all(centers >= lo, axis=1) & np.all(
                    centers <= hi, axis=1
                )
                if not box_keep.any():
                    continue
            keep = (
                (xs >= lo[0]) & (xs <= hi[0])
                & (ys >= lo[1]) & (ys <= hi[1])
                & (zs >= lo[2]) & (zs <= hi[2])
            )
            if keep.sum() < self.min_points:
                continue
            new_boxes = target_boxes[box_keep] if have_boxes else target_boxes
            new_pc = point_cloud[keep]
            new_labels = None
            if per_point_labels is not None:
                new_labels = [lab[keep] for lab in per_point_labels]
            return new_pc, new_boxes, new_labels
        return point_cloud, target_boxes, per_point_labels
