"""ScanNet detection dataset (reference datasets/scannet.py:298-660), a
numpy copy of `vdetr_tpu/data/scannet.py:79-279`: from the same
`np.random.RandomState` it gives the same sample, bit for bit.

Loads per-scan `{scan}_vert.npy / _ins_label.npy / _sem_label.npy /
_bbox.npy` produced by the JAX package's offline prep
(vdetr_tpu/data/prep_scannet.py), applies
the training augmentations (RandomCuboid crop, fixed-count resample,
flips, small z-rotation, translate, scale, color augs) and emits the
padded 64-slot GT dict.

As in the JAX package, the val split is padded/subsampled to a fixed
point budget too (with a validity mask), so a val batch has one static
shape; the reference feeds variable-size clouds at batch 1
(datasets/scannet.py:493 only subsamples under augmentation).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
from vdetr_tpu_torch.data.random_cuboid import RandomCuboid
from vdetr_tpu_torch.geometry.boxes import rotate_aligned_boxes_np

MEAN_COLOR_RGB = np.array([109.8, 97.2, 83.8])
IGNORE_LABEL = -100


def rotz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def random_sampling(pc, num_sample, rng, return_choices=False):
    replace = pc.shape[0] < num_sample
    choices = rng.choice(pc.shape[0], num_sample, replace=replace)
    return (pc[choices], choices) if return_choices else pc[choices]


def _hsv_color_aug(rgb, hue_max, sat_max, rng):
    """Hue/saturation jitter on 0-255 rgb (reference
    datasets/scannet.py:235-295). float32 throughout: colors are 8-bit
    data, float64 doubled the memory traffic of the ~10 array passes for
    nothing."""
    rgb = rgb.astype(np.float32)
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    # hue
    safe = np.maximum(delta, 1e-12)
    rc = (maxc - rgb[..., 0]) / safe
    gc = (maxc - rgb[..., 1]) / safe
    bc = (maxc - rgb[..., 2]) / safe
    h = np.select(
        [rgb[..., 0] == maxc, rgb[..., 1] == maxc],
        [bc - gc, 2.0 + rc - bc],
        default=4.0 + gc - rc,
    )
    h = (h / 6.0) % 1.0
    h = (h + (rng.rand() - 0.5) * 2 * hue_max + 1) % 1.0
    s = np.clip(s * (1 + (rng.rand() - 0.5) * 2 * sat_max), 0, 1)
    # hsv -> rgb
    i = (h * 6.0).astype(int) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    conds = [s == 0.0, i == 1, i == 2, i == 3, i == 4, i == 5]
    r = np.select(conds, [v, q, p, p, t, v], default=v)
    g = np.select(conds, [v, v, v, q, p, p], default=t)
    b = np.select(conds, [v, p, t, v, v, q], default=p)
    return np.clip(np.stack([r, g, b], -1), 0, 255)


class ScannetDetectionDataset:
    def __init__(self, cfg: VDETRConfig,
                 dataset_config: Optional[ScannetDatasetConfig] = None,
                 split_set: str = "train", augment: Optional[bool] = None,
                 use_random_cuboid: bool = True,
                 random_cuboid_min_points: int = 30000):
        self.cfg = cfg
        self.ds = dataset_config or ScannetDatasetConfig()
        assert split_set in ("train", "val")
        self.split = split_set
        self.augment = augment if augment is not None else split_set == "train"
        root = cfg.dataset_root_dir
        if root is None:
            raise ValueError("dataset_root_dir must point at prepared "
                             "ScanNet npy files")
        meta = cfg.meta_data_dir or root
        self.data_path = root
        all_scans = sorted({
            f[:12] for f in os.listdir(root) if f.startswith("scene")
        })
        split_file = os.path.join(meta, f"scannetv2_{split_set}.txt")
        if os.path.isfile(split_file):
            with open(split_file) as f:
                names = f.read().splitlines()
            self.scan_names = [s for s in names if s in all_scans]
        else:
            self.scan_names = all_scans
        if cfg.filt_empty:
            self.scan_names = [
                s for s in self.scan_names
                if np.load(os.path.join(root, s) + "_bbox.npy").shape[0] > 0
            ]
        self.random_cuboid = RandomCuboid(min_points=random_cuboid_min_points)
        self.use_random_cuboid = use_random_cuboid

    def __len__(self):
        return len(self.scan_names)

    def __getitem__(self, idx: int, rng: Optional[np.random.RandomState] = None
                    ) -> Dict[str, np.ndarray]:
        rng = rng or np.random.RandomState()
        cfg = self.cfg
        ds = self.ds
        scan = self.scan_names[idx]
        verts = np.load(os.path.join(self.data_path, scan) + "_vert.npy")
        bboxes = np.load(os.path.join(self.data_path, scan) + "_bbox.npy")

        if cfg.use_color:
            pc = verts[:, 0:6].copy()
            rgb = pc[:, 3:6]
            if self.augment:
                if cfg.color_drop > 0:
                    keep = rng.rand(len(pc)) > cfg.color_drop
                    rgb *= keep[:, None]
                if cfg.color_contrastp > 0 and rng.rand() < cfg.color_contrastp:
                    lo, hi = rgb.min(0, keepdims=True), rgb.max(0, keepdims=True)
                    contrast = (rgb - lo) * (255 / np.maximum(hi - lo, 1e-6))
                    blend = rng.rand()
                    rgb[:] = (1 - blend) * rgb + blend * contrast
                if cfg.color_jitterp > 0 and rng.rand() < cfg.color_jitterp:
                    rgb[:] = np.clip(
                        rgb + rng.randn(len(pc), 3) * 0.005 * 255, 0, 255
                    )
            # HSV aug + normalization are applied AFTER the crop/resample
            # below: both are per-point ops (the hue/sat shifts are global
            # scalars drawn independently of the points), so deferring
            # them is distribution-identical and runs on num_points
            # instead of the full scan (~1/3 fewer points; HSV was 40% of
            # the per-item time, tools/loader_bench.py).
        else:
            pc = verts[:, 0:3].copy()

        if cfg.use_normals:
            # precomputed by prep_scannet (the reference recomputes them
            # from the raw ply on every load, datasets/scannet.py:394-457)
            npath = os.path.join(self.data_path, scan) + "_normals.npy"
            if not os.path.isfile(npath):
                raise FileNotFoundError(
                    f"use_normals=True but {npath} is missing; re-run "
                    "vdetr_tpu_torch.data.prep_scannet to export normals"
                )
            pc = np.concatenate([pc, np.load(npath)], axis=1)

        point_valid = None
        if self.augment:
            if self.use_random_cuboid:
                pc, bboxes, _ = self.random_cuboid(pc, bboxes, rng=rng)
            pc, choices = random_sampling(pc, cfg.num_points, rng,
                                          return_choices=True)
        else:
            # fixed point budget (validity-masked when short)
            n = len(pc)
            if n >= cfg.num_points:
                pc = random_sampling(pc, cfg.num_points,
                                     np.random.RandomState(idx))
                point_valid = np.ones(cfg.num_points, bool)
            else:
                pad = np.zeros((cfg.num_points - n, pc.shape[1]),
                               pc.dtype)
                point_valid = np.zeros(cfg.num_points, bool)
                point_valid[:n] = True
                pc = np.concatenate([pc, pad])
        if point_valid is None:
            point_valid = np.ones(cfg.num_points, bool)

        if cfg.use_color:
            rgb = pc[:, 3:6]
            if self.augment:
                hue, sat, p = (float(x) for x in cfg.hue_sat.split("_"))
                if p > 0 and rng.rand() < p:
                    rgb[:] = _hsv_color_aug(rgb, hue, sat, rng)
            if cfg.color_mean < 0:
                pc[:, 3:6] = (rgb - MEAN_COLOR_RGB) / 256.0
            else:
                pc[:, 3:6] = rgb / 255.0 - 0.5
            # short-scan pad rows must stay all-zero (normalizing a zero
            # color would paint them with -MEAN/256)
            pc[~point_valid] = 0.0

        K = ds.max_num_obj
        target_bboxes = np.zeros((K, 6), np.float32)
        target_mask = np.zeros((K,), np.float32)
        nb = min(len(bboxes), K)
        target_mask[:nb] = 1
        target_bboxes[:nb] = bboxes[:nb, 0:6]

        # normals occupy the trailing 3 columns and must co-transform with
        # the coordinates (the reference leaves them untouched under flips
        # and rotations, datasets/scannet.py:514-542 — a latent bug; fixed
        # here and documented)
        nrm = slice(pc.shape[1] - 3, pc.shape[1]) if cfg.use_normals else None
        if self.augment:
            if rng.rand() > 0.5:  # YZ flip
                pc[:, 0] = -pc[:, 0]
                target_bboxes[:, 0] = -target_bboxes[:, 0]
                if nrm:
                    pc[:, nrm.start] = -pc[:, nrm.start]
            if rng.rand() > 0.5:  # XZ flip
                pc[:, 1] = -pc[:, 1]
                target_bboxes[:, 1] = -target_bboxes[:, 1]
                if nrm:
                    pc[:, nrm.start + 1] = -pc[:, nrm.start + 1]
            rot = ((rng.rand() * np.pi / 18) - np.pi / 36) * cfg.rot_ratio / 5.0
            mat = rotz(rot)
            pc[:, 0:3] = pc[:, 0:3] @ mat.T
            if nrm:
                pc[:, nrm] = pc[:, nrm] @ mat.T
            target_bboxes = rotate_aligned_boxes_np(target_bboxes, mat)
            if cfg.trans_ratio > 0:
                t = (rng.rand(3) - 0.5) * cfg.trans_ratio / 0.5
                pc[:, 0:3] += t
                target_bboxes[:, 0:3] += t
            if cfg.scale_ratio > 0:
                s = 1 + (rng.rand() - 0.5) * cfg.scale_ratio / 0.5
                pc[:, 0:3] *= s
                target_bboxes *= s

        raw_sizes = target_bboxes[:, 3:6].astype(np.float32)
        valid_pts = pc[point_valid, 0:3] if not point_valid.all() else pc[:, 0:3]
        dims_min = valid_pts.min(0).astype(np.float32)
        dims_max = valid_pts.max(0).astype(np.float32)
        scene = np.maximum(dims_max - dims_min, 1e-3)
        centers = target_bboxes[:, 0:3].astype(np.float32)
        centers_norm = ((centers - dims_min) / scene) * target_mask[:, None]
        sizes_norm = raw_sizes / scene
        raw_angles = np.zeros((K,), np.float32)
        corners = ds.box_parametrization_to_corners_np(
            centers, raw_sizes, raw_angles
        )
        sem_cls = np.zeros((K,), np.int64)
        if nb:
            sem_cls[:nb] = [
                ds.nyu40id2class[int(x)] for x in bboxes[:nb, -1]
            ]
        size_resid = np.zeros((K, 3), np.float32)
        if nb:
            size_resid[:nb] = raw_sizes[:nb] - ds.mean_size_arr[sem_cls[:nb]]

        # pad points at the scene minimum so they can't enter any box and
        # voxelize to a single always-present voxel
        if not point_valid.all():
            pc[~point_valid, 0:3] = dims_min

        return {
            "point_clouds": pc.astype(np.float32),
            "point_validity": point_valid,
            "gt_box_corners": corners.astype(np.float32),
            "gt_box_centers": centers,
            "gt_box_centers_normalized": centers_norm.astype(np.float32),
            "gt_box_sizes": raw_sizes,
            "gt_box_sizes_normalized": sizes_norm.astype(np.float32),
            "gt_box_sizes_residual_label": size_resid,
            "gt_box_angles": raw_angles,
            "gt_angle_class_label": np.zeros((K,), np.int64),
            "gt_angle_residual_label": np.zeros((K,), np.float32),
            "gt_box_sem_cls_label": sem_cls,
            "gt_box_present": target_mask,
            "scan_idx": np.int64(idx),
            "point_cloud_dims_min": dims_min,
            "point_cloud_dims_max": dims_max,
        }
