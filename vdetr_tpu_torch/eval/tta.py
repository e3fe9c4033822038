"""Test-time augmentation ensemble (a copy of `vdetr_tpu/eval/tta.py`).

The reference claims flip/rotate TTA (+~0.5 mAP, README.md:93) but never
released the code. This is the JAX package's recipe: run the model on
augmented copies of the scene (identity, X flip, Y flip, XY flip),
map predicted boxes back to the original frame, concatenate all
proposals, and let the evaluator's class-aware NMS merge them (scores
are kept; NMS keeps the most confident of overlapping duplicates).

Every view runs through the same eval step; only the (cheap) box
de-augmentation happens on the host, in numpy.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

DEFAULT_VIEWS: Tuple[Tuple[bool, bool, float], ...] = (
    (False, False, 0.0),
    (True, False, 0.0),
    (False, True, 0.0),
    (True, True, 0.0),
)


def augment_batch(batch: Dict[str, np.ndarray], flip_x: bool, flip_y: bool,
                  rot_z: float) -> Dict[str, np.ndarray]:
    """Augment the points (GT stays in the original frame)."""
    out = dict(batch)
    pc = np.array(batch["point_clouds"], copy=True)
    if flip_x:
        pc[..., 0] = -pc[..., 0]
    if flip_y:
        pc[..., 1] = -pc[..., 1]
    if rot_z != 0.0:
        c, s = np.cos(rot_z), np.sin(rot_z)
        x = pc[..., 0] * c - pc[..., 1] * s
        y = pc[..., 0] * s + pc[..., 1] * c
        pc[..., 0], pc[..., 1] = x, y
    out["point_clouds"] = pc
    out["point_cloud_dims_min"] = pc[..., :3].min(axis=1)
    out["point_cloud_dims_max"] = pc[..., :3].max(axis=1)
    return out


def deaugment_outputs(outputs: Dict[str, np.ndarray], flip_x: bool,
                      flip_y: bool, rot_z: float) -> Dict[str, np.ndarray]:
    """Map predicted boxes back to the original frame. Corner arrays are in
    the camera frame (x, -z_world? no: camera = (x_w, -z_w, y_w)), so a
    world X flip negates corner x, a world Y flip negates corner z."""
    out = {k: np.array(v, copy=True) for k, v in outputs.items()}
    center = out["center_unnormalized"]
    angle = out["angle_continuous"]
    if rot_z != 0.0:  # inverse rotation
        c, s = np.cos(-rot_z), np.sin(-rot_z)
        x = center[..., 0] * c - center[..., 1] * s
        y = center[..., 0] * s + center[..., 1] * c
        center[..., 0], center[..., 1] = x, y
        angle[:] = angle - rot_z
        for key in ("box_corners", "box_corners_axis_align"):
            cx = out[key][..., 0]
            cz = out[key][..., 2]  # camera z = world y
            out[key][..., 0] = cx * c - cz * s
            out[key][..., 2] = cx * s + cz * c
    if flip_x:
        center[..., 0] = -center[..., 0]
        angle[:] = np.pi - angle
        for key in ("box_corners", "box_corners_axis_align"):
            out[key][..., 0] = -out[key][..., 0]
    if flip_y:
        center[..., 1] = -center[..., 1]
        angle[:] = -angle
        for key in ("box_corners", "box_corners_axis_align"):
            out[key][..., 2] = -out[key][..., 2]
    out["center_unnormalized"] = center
    out["angle_continuous"] = np.mod(angle + np.pi, 2 * np.pi) - np.pi
    return out


def merge_views(view_outputs: List[Dict[str, np.ndarray]]
                ) -> Dict[str, np.ndarray]:
    """Concatenate proposals from all views along the query axis."""
    keys = view_outputs[0].keys()
    return {k: np.concatenate([v[k] for v in view_outputs], axis=1)
            for k in keys}


def _host(x):
    if isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().numpy()


def tta_eval_step(eval_step_fn, batch,
                  views: Sequence[Tuple[bool, bool, float]] = DEFAULT_VIEWS
                  ) -> Dict[str, np.ndarray]:
    """Run `eval_step_fn(batch)` (e.g. `Trainer.eval_step`, which moves the
    batch to its device) once per view and merge the views' outputs, as
    numpy arrays."""
    host_batch = {k: _host(v) for k, v in batch.items()}
    outs = []
    for fx, fy, rz in views:
        aug = augment_batch(host_batch, fx, fy, rz)
        out = {k: _host(v) for k, v in eval_step_fn(aug).items()}
        outs.append(deaugment_outputs(out, fx, fy, rz))
    return merge_views(outs)
