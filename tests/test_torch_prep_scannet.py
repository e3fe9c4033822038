"""The port's offline ScanNet preparation (`vdetr_tpu_torch/data/
prep_scannet.py`) against the JAX package's, on a tiny raw scan that the
test writes: a mesh in ascii and in binary PLY (both byte orders), its
segments, aggregation and meta files, and a labels tsv.

The JAX module reads PLY files through the `plyfile` package, which this
environment lacks; its reader is replaced by one that returns the mesh
the test wrote, and the port's own PLY reader is held to that mesh
exactly. Everything after the reader (alignment, normals, labels, boxes)
is the JAX module's own code. Integers must be equal, floats within
1e-6.
"""

import json

import numpy as np
import pytest

import vdetr_tpu.data.prep_scannet as jax_prep
from vdetr_tpu_torch.data import prep_scannet
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCAN = "scene0000_00"
# (raw category, nyu40 id): chair and table get boxes, wall does not
LABELS = [("chair", 5), ("table", 7), ("wall", 1)]


def _mesh(rng):
    verts = np.concatenate([rng.rand(40, 3).astype(np.float32) * 3,
                            rng.randint(0, 256, (40, 3)).astype(np.float32)],
                           axis=1)
    faces = np.stack([rng.choice(40, 3, replace=False) for _ in range(60)])
    return verts, faces.astype(np.int64)


def _write_ply(path, verts, faces, fmt):
    head = [b"ply", f"format {fmt} 1.0".encode(), b"comment tiny scan",
            f"element vertex {len(verts)}".encode()]
    head += [f"property float {c}".encode() for c in "xyz"]
    head += [f"property uchar {c}".encode() for c in ("red", "green", "blue")]
    head += [f"element face {len(faces)}".encode(),
             b"property list uchar int vertex_indices", b"end_header"]
    with open(path, "wb") as f:
        f.write(b"\n".join(head) + b"\n")
        if fmt == "ascii":
            for v in verts:
                f.write((" ".join(f"{x:.9g}" for x in v[:3]) + " "
                         + " ".join(str(int(c)) for c in v[3:]) + "\n"
                         ).encode())
            for face in faces:
                f.write(("3 " + " ".join(str(i) for i in face) + "\n"
                         ).encode())
            return
        order = "<" if fmt == "binary_little_endian" else ">"
        vdt = np.dtype([(c, order + "f4") for c in "xyz"]
                       + [(c, "u1") for c in ("red", "green", "blue")])
        rows = np.empty(len(verts), vdt)
        for i, c in enumerate("xyz"):
            rows[c] = verts[:, i]
        for i, c in enumerate(("red", "green", "blue")):
            rows[c] = verts[:, 3 + i]
        f.write(rows.tobytes())
        fdt = np.dtype([("n", "u1"), ("idx", order + "i4", (3,))])
        frows = np.empty(len(faces), fdt)
        frows["n"], frows["idx"] = 3, faces
        f.write(frows.tobytes())


def write_raw_scan(root, fmt, seed=0):
    """A raw scan in ScanNet's release layout under root/scans/SCAN and
    the labels tsv; returns (scans dir, tsv path, verts, faces)."""
    rng = np.random.RandomState(seed)
    verts, faces = _mesh(rng)
    scan_dir = root / "scans" / SCAN
    scan_dir.mkdir(parents=True)
    _write_ply(scan_dir / f"{SCAN}_vh_clean_2.ply", verts, faces, fmt)
    segs = rng.randint(0, 6, 40)
    (scan_dir / f"{SCAN}_vh_clean_2.0.010000.segs.json").write_text(
        json.dumps({"segIndices": segs.tolist()}))
    groups = [{"objectId": 0, "label": "chair", "segments": [0, 1]},
              {"objectId": 1, "label": "table", "segments": [2]},
              {"objectId": 2, "label": "wall", "segments": [3, 4]},
              {"objectId": 3, "label": "unknown", "segments": [5]},
              {"objectId": 4, "label": "chair", "segments": [99]}]
    (scan_dir / f"{SCAN}.aggregation.json").write_text(
        json.dumps({"segGroups": groups}))
    angle = 0.3
    align = np.eye(4)
    align[:2, :2] = [[np.cos(angle), -np.sin(angle)],
                     [np.sin(angle), np.cos(angle)]]
    align[:3, 3] = [0.5, -1.0, 0.2]
    (scan_dir / f"{SCAN}.txt").write_text(
        "sceneType = Living room\naxisAlignment = "
        + " ".join(f"{x:.9g}" for x in align.ravel()) + "\n")
    tsv = root / "labels.tsv"
    tsv.write_text("id\traw_category\tnyu40id\n" + "".join(
        f"{i}\t{name}\t{nyu}\n" for i, (name, nyu) in enumerate(LABELS)))
    return root / "scans", tsv, verts, faces


FORMATS = ["ascii", "binary_little_endian", "binary_big_endian"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_ply_reader_returns_the_mesh_written(fmt, tmp_path):
    _, _, verts, faces = write_raw_scan(tmp_path, fmt)
    got_v, got_f = prep_scannet.read_mesh_vertices_rgb(
        str(tmp_path / "scans" / SCAN / f"{SCAN}_vh_clean_2.ply"),
        return_faces=True)
    np.testing.assert_array_equal(got_v, verts)
    np.testing.assert_array_equal(got_f, faces)
    assert got_v.dtype == np.float32 and got_f.dtype == np.int64


@pytest.mark.parametrize("fmt", FORMATS)
def test_export_scan_matches_jax(fmt, tmp_path, monkeypatch):
    scans, tsv, verts, faces = write_raw_scan(tmp_path, fmt)
    monkeypatch.setattr(
        jax_prep, "read_mesh_vertices_rgb",
        lambda path, return_faces=False: (verts.copy(), faces.copy()))
    want = jax_prep.export_scan(str(scans / SCAN), SCAN,
                                jax_prep.read_label_mapping(str(tsv)))
    got = prep_scannet.export_scan(str(scans / SCAN), SCAN,
                                   prep_scannet.read_label_mapping(str(tsv)))
    names = ("vert", "normals", "sem_label", "ins_label", "bbox")
    for name, w, g in zip(names, want, got):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                       err_msg=name)
    # the two instances of box classes with vertices: chair and table
    assert len(want[4]) == 2


def test_cli_writes_what_the_loader_reads(tmp_path, monkeypatch):
    scans, tsv, verts, faces = write_raw_scan(tmp_path, "binary_little_endian")
    out = tmp_path / "scannet_data"
    prep_scannet.main(["--scans_dir", str(scans), "--labels_tsv", str(tsv),
                       "--out_dir", str(out)])
    monkeypatch.setattr(
        jax_prep, "read_mesh_vertices_rgb",
        lambda path, return_faces=False: (verts.copy(), faces.copy()))
    want = jax_prep.export_scan(str(scans / SCAN), SCAN,
                                jax_prep.read_label_mapping(str(tsv)))
    for name, w in zip(("vert", "normals", "sem_label", "ins_label", "bbox"),
                       want):
        got = np.load(out / f"{SCAN}_{name}.npy")
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-6, err_msg=name)
