"""Scene and detection dumps (torch counterpart of
`vdetr_tpu/utils/viz.py`; reference scannet/data_viz.py): PLY point
clouds and OBJ wireframes of boxes, to look at scenes and detections in
MeshLab or CloudCompare. Plain ascii, no plyfile; the bytes are the JAX
package's for the same arrays.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def write_ply(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None):
    """points (N, 3); colors (N, 3) in 0-255 or None."""
    header = ["ply", "format ascii 1.0", f"element vertex {len(points)}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    with open(path, "w") as f:
        f.write("\n".join(header + ["end_header"]) + "\n")
        for i, p in enumerate(points):
            row = f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"
            if colors is not None:
                c = colors[i].astype(int)
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")


def write_boxes_obj(path: str, corners: np.ndarray):
    """corners (K, 8, 3) -> OBJ wireframes, a box's 12 edges as lines."""
    with open(path, "w") as f:
        for box in corners:
            for v in box:
                f.write(f"v {v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n")
        for k in range(len(corners)):
            for a, b in _BOX_EDGES:
                f.write(f"l {8 * k + a + 1} {8 * k + b + 1}\n")


def dump_scene(out_dir: str, name: str, points: np.ndarray,
               gt_corners: Optional[np.ndarray] = None,
               pred_corners: Optional[np.ndarray] = None,
               colors: Optional[np.ndarray] = None):
    """`<name>_pc.ply`, and `<name>_gt.obj` / `<name>_pred.obj` where
    there are boxes, in `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    write_ply(os.path.join(out_dir, f"{name}_pc.ply"), points, colors)
    for tag, corners in (("gt", gt_corners), ("pred", pred_corners)):
        if corners is not None and len(corners):
            write_boxes_obj(os.path.join(out_dir, f"{name}_{tag}.obj"),
                            corners)
