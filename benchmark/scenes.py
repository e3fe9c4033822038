"""The benchmark's scenes: synthetic indoor rooms and the batches a cell
feeds the program.

`make_scene` is a frozen copy of `vdetr_tpu_torch/data/synthetic.py:
SyntheticDetectionDataset.__getitem__` (commit 9762b5a), so that a later
change to the program's generator cannot change the benchmark's inputs.
The dataset constants (class count, angle bins, mean sizes) come from the
configuration file. Rooms of 4-7 m with 3-10 box-shaped objects, points
on the object surfaces and on floor and wall at ~1 cm density, resampled
to a fixed count; yawed boxes where the dataset has angle bins.

A traffic file fixes the pool: `pool_scenes` rooms drawn from
`scene_seed`, the same rooms for every run. `--seed` fixes their order,
so that every seed gives the program the same work in another order.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

INPUT_KEYS = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max",
              "point_validity")


def _corners_np(box_size, angle, center):
    sx = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64)
    sy = np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float64)
    sz = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64)
    l = box_size[..., 0:1] * 0.5
    w = box_size[..., 1:2] * 0.5
    h = box_size[..., 2:3] * 0.5
    corners = np.stack([l * sx, h * sy, w * sz], axis=-1)
    c, s = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    R = np.stack([np.stack([c, zeros, s], axis=-1),
                  np.stack([zeros, ones, zeros], axis=-1),
                  np.stack([-s, zeros, c], axis=-1)], axis=-2)
    corners = (corners[..., None, :] * R[..., None, :, :]).sum(-1)
    return (corners + center[..., None, :]).astype(np.float32)


def box_corners_np(center, size, angle):
    """Camera-frame corners of depth-frame boxes (the dataset config's
    `box_parametrization_to_corners_np`)."""
    cam = np.stack([center[..., 0], -center[..., 2], center[..., 1]], -1)
    return _corners_np(size, angle, cam)


def angle2class(angle: float, num_angle_bin: int):
    """(bin, residual) of a yaw: bins of width 2 pi / N centred at 0, 2 pi
    / N, ... (the SUN RGB-D config's `angle2class`)."""
    angle = angle % (2 * np.pi)
    per = 2 * np.pi / num_angle_bin
    shifted = (angle + per / 2) % (2 * np.pi)
    cls = int(shifted / per)
    return cls, shifted - (cls * per + per / 2)


def make_scene(ds: dict, num_points: int, seed: int,
               min_objects: int = 3, max_objects: int = 10
               ) -> Dict[str, np.ndarray]:
    """One room from `np.random.RandomState(seed)`; `ds` the configuration
    file's `dataset_config`."""
    rng = np.random.RandomState(seed)
    K = ds["max_num_obj"]
    num_semcls = ds["num_semcls"]
    nbins = ds["num_angle_bin"]
    mean_sizes = np.asarray(ds["mean_size_arr"], np.float64)
    rotated = nbins > 1
    room = rng.rand(2) * 3 + 4.0  # 4-7m footprint
    height = 2.5 + rng.rand() * 0.7

    n_obj = rng.randint(min_objects, max_objects + 1)
    centers = np.zeros((K, 3), np.float32)
    sizes = np.zeros((K, 3), np.float32)
    angles = np.zeros((K,), np.float32)
    labels = np.zeros((K,), np.int64)
    present = np.zeros((K,), np.float32)

    pts_parts = []
    for i in range(n_obj):
        cls = rng.randint(num_semcls)
        size = (mean_sizes[cls] * np.exp(rng.randn(3) * 0.1)).astype(
            np.float32)
        size = np.clip(size, 0.1, None)
        cx = rng.rand() * (room[0] - size[0]) + size[0] / 2
        cy = rng.rand() * (room[1] - size[1]) + size[1] / 2
        cz = size[2] / 2
        ang = 0.0
        if rotated:
            ang = float(rng.rand() * 2 * np.pi - np.pi)
        centers[i] = (cx, cy, cz)
        sizes[i] = size
        angles[i] = ang
        labels[i] = cls
        present[i] = 1.0
        area = 2 * (size[0] * size[1] + size[0] * size[2]
                    + size[1] * size[2])
        npts = int(np.clip(area / 2e-4, 400, 20000))
        face = rng.randint(0, 6, npts)
        u = rng.rand(npts, 3) - 0.5
        for ax in range(3):
            sel = face // 2 == ax
            u[sel, ax] = 0.5 * np.sign(face[sel] % 2 - 0.5)
        local = u * size
        if ang != 0.0:
            c, s = np.cos(ang), np.sin(ang)
            R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            local = local @ R.T
        pts_parts.append(local + centers[i])

    nfloor = int(np.clip(room[0] * room[1] / 2e-4, 2000, 40000))
    floor = np.stack([rng.rand(nfloor) * room[0], rng.rand(nfloor) * room[1],
                      np.abs(rng.randn(nfloor)) * 0.01], axis=1)
    nwall = int(np.clip(room[0] * height / 2e-4, 1000, 20000))
    wall = np.stack([rng.rand(nwall) * room[0], np.zeros(nwall) + 0.01,
                     rng.rand(nwall) * height], axis=1)
    pts = np.concatenate(pts_parts + [floor, wall]).astype(np.float32)
    choice = rng.choice(len(pts), num_points,
                        replace=len(pts) < num_points)
    point_cloud = pts[choice]

    dmin = point_cloud.min(0)
    dmax = point_cloud.max(0)
    scene = np.maximum(dmax - dmin, 1e-3)
    centers_norm = (centers - dmin) / scene * present[:, None]
    sizes_norm = sizes / scene
    corners = box_corners_np(centers, sizes, angles)
    angle_cls = np.zeros((K,), np.int64)
    angle_res = np.zeros((K,), np.float32)
    if rotated:
        for i in range(n_obj):
            angle_cls[i], angle_res[i] = angle2class(angles[i], nbins)
    return {
        "point_clouds": point_cloud.astype(np.float32),
        "point_validity": np.ones((num_points,), bool),
        "gt_box_corners": corners.astype(np.float32),
        "gt_box_centers": centers,
        "gt_box_centers_normalized": centers_norm.astype(np.float32),
        "gt_box_sizes": sizes,
        "gt_box_sizes_normalized": sizes_norm.astype(np.float32),
        "gt_box_angles": angles,
        "gt_angle_class_label": angle_cls,
        "gt_angle_residual_label": angle_res,
        "gt_box_sem_cls_label": labels,
        "gt_box_present": present,
        "point_cloud_dims_min": dmin.astype(np.float32),
        "point_cloud_dims_max": dmax.astype(np.float32),
    }


def scene_pool(traffic: dict, ds: dict) -> List[Dict[str, np.ndarray]]:
    """The traffic file's pool of rooms, in the generator's order."""
    return [make_scene(ds, traffic["num_points"],
                       traffic["scene_seed"] * 100003 + i,
                       traffic["min_objects"], traffic["max_objects"])
            for i in range(traffic["pool_scenes"])]


def batch_order(n_scenes: int, batch: int, seed: int) -> List[np.ndarray]:
    """The run's batches: a permutation of the pool drawn from `seed`,
    cut into batches of `batch` scenes (every scene once per cycle)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5CE7E]))
    perm = rng.permutation(n_scenes)
    return [perm[i:i + batch] for i in range(0, n_scenes - batch + 1, batch)]


def collate(scenes, idx) -> Dict[str, np.ndarray]:
    return {k: np.stack([scenes[i][k] for i in idx]) for k in scenes[0]}
