"""Offline ScanNet preparation: the port's copy of
`vdetr_tpu/data/prep_scannet.py` (reference scannet/load_scannet_data.py
and scannet/batch_load_scannet_data.py), numpy only.

For each scan, reads the raw ScanNet release files (`_vh_clean_2.ply`,
`_vh_clean_2.0.010000.segs.json`, `.aggregation.json`, `.txt` meta),
axis-aligns the mesh with the `axisAlignment` matrix from the meta file,
maps raw categories to nyu40 ids via `scannetv2-labels.combined.tsv`,
and writes what `data/scannet.py` reads:

  <scan>_vert.npy       (N, 6) xyz + rgb
  <scan>_normals.npy    (N, 3) area-weighted vertex normals (the reference
                        recomputes these from the raw ply at every load
                        when --use_normals, datasets/scannet.py:394-430)
  <scan>_sem_label.npy  (N,)   nyu40 semantic id per vertex
  <scan>_ins_label.npy  (N,)   1-based instance id (0 = unannotated)
  <scan>_bbox.npy       (K, 7) cx cy cz dx dy dz nyu40id, axis-aligned
                        boxes from instance point extents

The PLY reader is this module's own (`read_ply`: ascii and binary, either
byte order), where the JAX module uses the `plyfile` package.

Usage:
  python -m vdetr_tpu_torch.data.prep_scannet --scans_dir scans/ \\
      --labels_tsv scannetv2-labels.combined.tsv --out_dir scannet_data/
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, List, Tuple

import numpy as np

# classes whose instances get boxes (reference
# scannet/batch_load_scannet_data.py OBJ_CLASS_IDS)
OBJ_CLASS_IDS = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]
)

# PLY scalar types -> numpy (both spellings of the format spec)
_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def read_label_mapping(tsv_path: str, label_from="raw_category",
                       label_to="nyu40id") -> Dict[str, int]:
    mapping = {}
    with open(tsv_path, newline="") as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            mapping[row[label_from]] = int(row[label_to])
    return mapping


def _parse_header(f) -> Tuple[str, List[tuple]]:
    """(format, elements): each element (name, count, properties), each
    property (name, numpy type) or (name, count type, item type) for a
    list."""
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt, elements = None, []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("PLY header has no end_header")
        words = line.decode("ascii").split()
        if not words or words[0] in ("comment", "obj_info"):
            continue
        if words[0] == "end_header":
            return fmt, elements
        if words[0] == "format":
            fmt = words[1]
        elif words[0] == "element":
            elements.append((words[1], int(words[2]), []))
        elif words[0] == "property":
            if words[1] == "list":
                elements[-1][2].append((words[4], _PLY_TYPES[words[2]],
                                        _PLY_TYPES[words[3]]))
            else:
                elements[-1][2].append((words[2], _PLY_TYPES[words[1]]))


def _read_binary(f, count, props, order):
    """An element's rows from a binary body: a structured array where no
    property is a list, else a list of per-row dicts (lists as arrays)."""
    if all(len(p) == 2 for p in props):
        dt = np.dtype([(name, order + t) for name, t in props])
        return np.frombuffer(f.read(dt.itemsize * count), dt, count)
    if len(props) == 1 and count > 0:
        # one list a row (a mesh's faces): read at once if every row has
        # the first row's length
        name, ct, it = props[0]
        start = f.tell()
        cdt = np.dtype(order + ct)
        n = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
        f.seek(start)
        dt = np.dtype([("n", cdt), (name, order + it, (n,))])
        block = f.read(dt.itemsize * count)
        if len(block) == dt.itemsize * count:
            rows = np.frombuffer(block, dt, count)
            if (rows["n"] == n).all():
                return [{name: r} for r in rows[name]]
        f.seek(start)
    rows = []
    for _ in range(count):
        row = {}
        for p in props:
            if len(p) == 2:
                dt = np.dtype(order + p[1])
                row[p[0]] = np.frombuffer(f.read(dt.itemsize), dt)[0]
            else:
                cdt, idt = np.dtype(order + p[1]), np.dtype(order + p[2])
                n = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
                row[p[0]] = np.frombuffer(f.read(idt.itemsize * n), idt)
        rows.append(row)
    return rows


def _read_ascii(f, count, props):
    rows = []
    for _ in range(count):
        vals = f.readline().split()
        row, i = {}, 0
        for p in props:
            if len(p) == 2:
                row[p[0]] = np.array(vals[i].decode(), np.dtype(p[1]))
                i += 1
            else:
                n = int(vals[i])
                row[p[0]] = np.array([v.decode() for v in vals[i + 1:i + 1 + n]],
                                     np.dtype(p[2]))
                i += 1 + n
        rows.append(row)
    return rows


def read_ply(path: str) -> Dict[str, object]:
    """{element name: its rows} of a PLY file: a structured array for an
    element of scalar properties, else a list of per-row dicts. ascii,
    binary_little_endian and binary_big_endian."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        out = {}
        for name, count, props in elements:
            if fmt == "ascii":
                rows = _read_ascii(f, count, props)
                if all(len(p) == 2 for p in props):
                    rows = np.array(
                        [tuple(r[p[0]] for p in props) for r in rows],
                        np.dtype([(p[0], p[1]) for p in props]))
            elif fmt in ("binary_little_endian", "binary_big_endian"):
                order = "<" if fmt == "binary_little_endian" else ">"
                rows = _read_binary(f, count, props, order)
            else:
                raise ValueError(f"unknown PLY format {fmt!r}")
            out[name] = rows
        return out


def read_mesh_vertices_rgb(ply_path: str, return_faces: bool = False):
    ply = read_ply(ply_path)
    v = ply["vertex"]
    out = np.stack(
        [v["x"], v["y"], v["z"], v["red"], v["green"], v["blue"]], axis=1
    ).astype(np.float32)
    if return_faces:
        faces = np.vstack([r["vertex_indices"] for r in ply["face"]]
                          ).astype(np.int64)
        return out, faces
    return out


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (reference datasets/scannet.py:397-430
    face_normal/vertex_normal, computed there lazily at load time from the
    raw ply; exported offline here)."""
    v01 = verts[faces[:, 1], :3] - verts[faces[:, 0], :3]
    v02 = verts[faces[:, 2], :3] - verts[faces[:, 0], :3]
    vec = np.cross(v01, v02)
    length = np.sqrt((vec ** 2).sum(1, keepdims=True)) + 1e-8
    nf = vec / length           # unit face normal
    area = length * 0.5
    weighted = nf * area        # reference weights by face area
    out = np.zeros((verts.shape[0], 3), np.float64)
    for k in range(3):
        np.add.at(out, faces[:, k], weighted)
    norm = np.sqrt((out ** 2).sum(1, keepdims=True)) + 1e-8
    return (out / norm).astype(np.float32)


def export_scan(scan_dir: str, scan_name: str, label_map: Dict[str, int]):
    mesh_file = os.path.join(scan_dir, scan_name + "_vh_clean_2.ply")
    agg_file = os.path.join(scan_dir, scan_name + ".aggregation.json")
    seg_file = os.path.join(
        scan_dir, scan_name + "_vh_clean_2.0.010000.segs.json"
    )
    meta_file = os.path.join(scan_dir, scan_name + ".txt")

    verts, faces = read_mesh_vertices_rgb(mesh_file, return_faces=True)

    # axis alignment from the meta file
    axis_align = np.eye(4)
    with open(meta_file) as f:
        for line in f:
            if line.startswith("axisAlignment"):
                vals = [float(x) for x in line.split("=")[1].split()]
                axis_align = np.array(vals).reshape(4, 4)
                break
    pts = np.ones((verts.shape[0], 4))
    pts[:, :3] = verts[:, :3]
    verts[:, :3] = (pts @ axis_align.T)[:, :3]
    # normals from the aligned mesh (alignment is rigid, so this equals
    # aligning raw-mesh normals)
    normals = vertex_normals(verts, faces)

    with open(seg_file) as f:
        seg_to_vert: Dict[int, list] = {}
        seg_indices = json.load(f)["segIndices"]
        for i, s in enumerate(seg_indices):
            seg_to_vert.setdefault(s, []).append(i)

    with open(agg_file) as f:
        agg = json.load(f)["segGroups"]

    n = verts.shape[0]
    sem_label = np.zeros(n, np.int64)
    ins_label = np.zeros(n, np.int64)
    instance_boxes = []
    for obj in agg:
        obj_id = obj["objectId"] + 1  # 1-based
        nyu40 = label_map.get(obj["label"], 0)
        vert_ids = []
        for seg in obj["segments"]:
            vert_ids.extend(seg_to_vert.get(seg, []))
        vert_ids = np.asarray(vert_ids, np.int64)
        if len(vert_ids) == 0:
            continue
        sem_label[vert_ids] = nyu40
        ins_label[vert_ids] = obj_id
        if nyu40 in OBJ_CLASS_IDS:
            obj_pts = verts[vert_ids, :3]
            mn, mx = obj_pts.min(0), obj_pts.max(0)
            center = (mn + mx) / 2
            size = mx - mn
            instance_boxes.append(np.concatenate([center, size, [nyu40]]))
    boxes = (np.stack(instance_boxes) if instance_boxes
             else np.zeros((0, 7)))
    return verts, normals, sem_label, ins_label, boxes.astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans_dir", required=True)
    ap.add_argument("--labels_tsv", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--scan_names", nargs="*", default=None)
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    label_map = read_label_mapping(args.labels_tsv)
    scans = args.scan_names or sorted(os.listdir(args.scans_dir))
    for scan in scans:
        scan_dir = os.path.join(args.scans_dir, scan)
        if not os.path.isdir(scan_dir):
            continue
        out_prefix = os.path.join(args.out_dir, scan)
        if os.path.exists(out_prefix + "_bbox.npy"):
            continue
        try:
            verts, normals, sem, ins, boxes = export_scan(scan_dir, scan,
                                                          label_map)
        except FileNotFoundError as e:
            print(f"skip {scan}: {e}")
            continue
        np.save(out_prefix + "_vert.npy", verts)
        np.save(out_prefix + "_normals.npy", normals)
        np.save(out_prefix + "_sem_label.npy", sem)
        np.save(out_prefix + "_ins_label.npy", ins)
        np.save(out_prefix + "_bbox.npy", boxes)
        print(f"{scan}: {verts.shape[0]} verts, {boxes.shape[0]} boxes")


if __name__ == "__main__":
    main()
