"""The port's ScanNet downloader (`vdetr_tpu_torch/data/download_scannet.py`)
against the JAX package's, offline.

Both modules' `BASE_URL` is patched to a `file://` URL of a release that
the test fabricates under `tmp_path` (`v2/scans.txt` and `v1/scans.txt`
with blank lines, a few scans' files in both releases, both label maps,
the v1 task zips), and `builtins.input` is patched for the TOS prompt.
Each module's `main` runs into its own output directory; the two output
trees must be equal byte for byte, stdout and stderr equal once each
output directory is swapped for a placeholder, and the exit codes equal.
Nothing reaches the network.

The last test takes the path a user takes: the port downloads a
fabricated raw scan (`test_torch_prep_scannet.write_raw_scan`) and the
label map, the port's prep reads what it wrote, and the port's ScanNet
dataset loads a sample of the result.
"""

import builtins
import os
import shutil

import numpy as np
import pytest

import vdetr_tpu.data.download_scannet as jax_dl
from test_torch_prep_scannet import SCAN, write_raw_scan
from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.data import download_scannet as port_dl
from vdetr_tpu_torch.data import prep_scannet
from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
from vdetr_tpu_torch.data.scannet import ScannetDetectionDataset
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

V2_SCANS = ["scene0000_00", "scene0000_01", "scene0707_00"]
V1_SCANS = ["scene0000_00", "scene0101_02"]
TASK_FILES = ("obj_classification/data.zip",
              "obj_classification/trained_models.zip",
              "voxel_labeling/data.zip", "voxel_labeling/trained_models.zip",
              "benchmark/scannet-benchmark.zip")


def _put(path, data):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)


def fabricate_release(root, skip=()):
    """A ScanNet release under root: the scan lists (blank lines among
    them), every file type of every scan in v2 and v1 (each file's bytes
    name it), the label maps and the task zips. Files whose path relative
    to root is in `skip` are left out. Returns the release's URL."""
    (root / "v2").mkdir(parents=True)
    (root / "v1").mkdir()
    (root / "v2" / "scans.txt").write_text(
        "\n".join(V2_SCANS[:2]) + "\n\n  \n" + V2_SCANS[2] + "\n")
    (root / "v1" / "scans.txt").write_text("\n".join(V1_SCANS) + "\n\n")
    files = {f"{rel}/{sid}/{sid}{ft}"
             for rel, scans in (("v2/scans", V2_SCANS), ("v1/scans", V1_SCANS))
             for sid in scans for ft in port_dl.FILETYPES}
    files |= {"v2/tasks/scannetv2-labels.combined.tsv",
              "v1/tasks/scannet-labels.combined.tsv"}
    files |= {f"v1/tasks/{f}" for f in TASK_FILES}
    for rel in sorted(files - set(skip)):
        _put(root / rel, f"{rel}\n".encode() * 3)
    return root.as_uri() + "/"


@pytest.fixture
def release(tmp_path, monkeypatch):
    url = fabricate_release(tmp_path / "release")
    for mod in (jax_dl, port_dl):
        monkeypatch.setattr(mod, "BASE_URL", url)
    return url


def tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def run_both(tmp_path, capsys, argv, answer=""):
    """Each module's `main(["-o", its own dir] + argv)`, the prompt
    answered by `answer` (an exception to raise, or the line typed):
    [(exit code or SystemExit code, stdout, stderr, output tree)] for JAX
    and for the port, each output dir swapped for a placeholder."""
    def typed(prompt=""):
        if isinstance(answer, BaseException):
            raise answer
        return answer

    results = []
    for name, mod in (("jax", jax_dl), ("port", port_dl)):
        out = tmp_path / f"out_{name}"
        capsys.readouterr()
        orig, builtins.input = builtins.input, typed
        try:
            rc = mod.main(["-o", str(out)] + argv)
        except SystemExit as e:
            rc = ("exit", e.code)
        finally:
            builtins.input = orig
        printed = capsys.readouterr()
        results.append((rc, printed.out.replace(str(out), "OUT"),
                        printed.err.replace(str(out), "OUT"),
                        tree(out) if out.exists() else None))
    return results


FLAG_SETS = {
    "id": ["--id", "scene0000_01"],
    "id_type": ["--id", "scene0707_00", "--type", "_vh_clean_2.ply"],
    "id_test_scans": ["--id", "scene0000_00", "--test_scans"],
    "v1_id": ["--v1", "--id", "scene0101_02"],
    "scan_list": [],
    "label_map": ["--label_map"],
    "label_map_v1": ["--label_map", "--v1"],
    "task_data": ["--task_data"],
    "label_map_task_data": ["--label_map", "--task_data"],
}


def expected_fetches(flags):
    """The output paths, relative to OUT, that a run with `flags` fetches
    to, in order (a path may come twice: see the task data)."""
    if "--label_map" in flags:
        return [port_dl.LABEL_MAP_FILES["v1" if "--v1" in flags else "v2"]]
    if "--task_data" in flags:
        return [os.path.join("tasks", os.path.basename(f))
                for f in TASK_FILES]
    release = "v1" if "--v1" in flags else "v2"
    scans = [flags[flags.index("--id") + 1]] if "--id" in flags else \
        (V1_SCANS if release == "v1" else V2_SCANS)
    types = [flags[flags.index("--type") + 1]] if "--type" in flags else (
        port_dl.FILETYPES_TEST if "--test_scans" in flags
        else port_dl.FILETYPES)
    return [os.path.join("scans", s, s + t) for s in scans for t in types]


@pytest.mark.parametrize("dry_run", [False, True], ids=["fetch", "dry_run"])
@pytest.mark.parametrize("flags", list(FLAG_SETS.values()),
                         ids=list(FLAG_SETS))
def test_flag_set_matches_jax(flags, dry_run, release, tmp_path, capsys):
    argv = flags + (["--dry_run"] if dry_run else [])
    (rc_j, out_j, err_j, tree_j), (rc_p, out_p, err_p, tree_p) = run_both(
        tmp_path, capsys, argv)
    assert rc_p == rc_j == 0
    assert out_p == out_j
    assert err_p == err_j == ""
    assert tree_p == tree_j
    if dry_run:
        assert tree_p is None  # nothing written, not even a directory
        assert "TOS" not in out_p  # --dry_run skips the prompt
        assert out_p.count("[dry-run]") == len(expected_fetches(flags))
        return
    assert "Press Enter to continue" in out_p
    assert set(tree_p) == set(expected_fetches(flags))
    for rel, data in tree_p.items():  # each file from its own URL
        assert data.decode().splitlines()[0].endswith(
            rel.split(os.sep)[-1])
    if "--task_data" in flags and "--label_map" not in flags:
        # voxel_labeling's data.zip and trained_models.zip land on the
        # paths obj_classification's took, and are skipped as present
        assert out_p.count("exists, skipping") == 2
        assert tree_p[os.path.join("tasks", "data.zip")].startswith(
            b"v1/tasks/obj_classification/data.zip")
    if not flags:
        assert f"{len(V2_SCANS)} scans in the v2 release" in out_p


@pytest.mark.parametrize("dry_run", [False, True], ids=["fetch", "dry_run"])
def test_present_file_is_skipped(dry_run, release, tmp_path, capsys):
    rel = os.path.join("scans", "scene0000_01", "scene0000_01.txt")
    for name in ("jax", "port"):
        _put(tmp_path / f"out_{name}" / rel, b"local copy\n")
    argv = ["--id", "scene0000_01", "--yes"] + (
        ["--dry_run"] if dry_run else [])
    (rc_j, out_j, err_j, tree_j), (rc_p, out_p, err_p, tree_p) = run_both(
        tmp_path, capsys, argv)
    assert (rc_p, out_p, err_p, tree_p) == (rc_j, out_j, err_j, tree_j)
    assert rc_p == 0
    assert f"  OUT/{rel} exists, skipping" in out_p.splitlines()
    assert tree_p[rel] == b"local copy\n"
    assert len(tree_p) == (1 if dry_run else len(port_dl.FILETYPES))


def test_failed_fetch_leaves_no_temp_file_and_exits_0(tmp_path, capsys,
                                                      monkeypatch):
    """A file missing on the server: the temp file is removed, the error
    goes to stderr, the other files are fetched, and the exit code stays
    0 (`download_scan` ignores `download_file`'s False)."""
    missing = "v2/scans/scene0000_00/scene0000_00.sens"
    url = fabricate_release(tmp_path / "release", skip={missing})
    for mod in (jax_dl, port_dl):
        monkeypatch.setattr(mod, "BASE_URL", url)
    (rc_j, out_j, err_j, tree_j), (rc_p, out_p, err_p, tree_p) = run_both(
        tmp_path, capsys, ["--id", "scene0000_00", "--yes"])
    assert (rc_p, out_p, err_p, tree_p) == (rc_j, out_j, err_j, tree_j)
    assert rc_p == 0
    assert err_p.startswith(f"  ERROR downloading {url}{missing}: ")
    assert sorted(os.listdir(tmp_path / "out_port" / "scans"
                             / "scene0000_00")) == sorted(
        "scene0000_00" + t for t in port_dl.FILETYPES if t != ".sens")


def test_prompt_interrupted_returns_1(release, tmp_path, capsys):
    (rc_j, out_j, err_j, tree_j), (rc_p, out_p, err_p, tree_p) = run_both(
        tmp_path, capsys, ["--id", "scene0000_00"],
        answer=KeyboardInterrupt())
    assert rc_p == rc_j == 1
    assert out_p == out_j and "ScanNet_TOS.pdf" in out_p
    assert tree_p is tree_j is None


def test_prompt_other_errors_propagate(release, tmp_path, monkeypatch):
    """Only Ctrl-C is caught at the prompt: end of input propagates from
    both, before anything is written."""
    def eof(prompt=""):
        raise EOFError

    monkeypatch.setattr(builtins, "input", eof)
    for name, mod in (("jax", jax_dl), ("port", port_dl)):
        with pytest.raises(EOFError):
            mod.main(["-o", str(tmp_path / name), "--label_map"])
        assert not (tmp_path / name).exists()


def test_unknown_type_exits_2(release, tmp_path, capsys):
    (rc_j, _, err_j, tree_j), (rc_p, _, err_p, tree_p) = run_both(
        tmp_path, capsys, ["--id", "scene0000_00", "--type", ".obj"])
    assert rc_p == rc_j == ("exit", 2)
    assert err_p == err_j and "invalid choice" in err_p
    assert tree_p is tree_j is None


def test_cli_flags_equal_jax():
    def flags(mod):
        import argparse

        seen = []
        orig = argparse.ArgumentParser.parse_args

        def grab(self, argv=None, namespace=None):
            seen.extend((a.option_strings, a.choices, a.default, a.required)
                        for a in self._actions)
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                mod.main([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    assert flags(port_dl) == flags(jax_dl)
    for name in ("BASE_URL", "TOS_URL", "FILETYPES", "FILETYPES_TEST",
                 "RELEASES", "RELEASES_TASKS", "RELEASE_SIZE",
                 "LABEL_MAP_FILES"):
        assert getattr(port_dl, name) == getattr(jax_dl, name), name


PREP_TYPES = ("_vh_clean_2.ply", "_vh_clean_2.0.010000.segs.json",
              ".aggregation.json", ".txt")
NPY = ("vert", "normals", "sem_label", "ins_label", "bbox")


def test_download_prep_and_load(tmp_path, monkeypatch, capsys):
    """download -> prep -> loader: a raw scan served as a v2 release is
    fetched type by type with the label map, prepared by the port's prep
    into the same five arrays as the source directory gives, and loaded
    by the port's ScanNet dataset."""
    src = tmp_path / "src"
    scans_src, tsv_src, verts, _ = write_raw_scan(src, "binary_little_endian")
    rel = tmp_path / "release"
    shutil.copytree(scans_src / SCAN, rel / "v2" / "scans" / SCAN)
    _put(rel / "v2" / "tasks" / port_dl.LABEL_MAP_FILES["v2"],
         tsv_src.read_bytes())
    monkeypatch.setattr(port_dl, "BASE_URL", rel.as_uri() + "/")

    out = tmp_path / "scannet"
    for ft in PREP_TYPES:
        assert port_dl.main(["-o", str(out), "--id", SCAN, "--type", ft,
                             "--yes"]) == 0
    assert port_dl.main(["-o", str(out), "--label_map", "--yes"]) == 0
    assert capsys.readouterr().err == ""
    tsv = out / port_dl.LABEL_MAP_FILES["v2"]
    assert sorted(os.listdir(out)) == sorted(["scans", tsv.name])

    for scans, labels, dst in ((out / "scans", tsv, "from_download"),
                               (scans_src, tsv_src, "from_source")):
        prep_scannet.main(["--scans_dir", str(scans), "--labels_tsv",
                           str(labels), "--out_dir", str(tmp_path / dst)])
    for name in NPY:
        got = np.load(tmp_path / "from_download" / f"{SCAN}_{name}.npy")
        want = np.load(tmp_path / "from_source" / f"{SCAN}_{name}.npy")
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert len(np.load(tmp_path / "from_download" / f"{SCAN}_bbox.npy")) == 2

    cfg = VDETRConfig(dataset_root_dir=str(tmp_path / "from_download"),
                      num_points=32)
    data = ScannetDetectionDataset(cfg, ScannetDatasetConfig(), "val")
    assert data.scan_names == [SCAN]
    sample = data.__getitem__(0, rng=np.random.RandomState(0))
    assert sample["point_clouds"].shape == (32, 3)
    assert np.isfinite(sample["point_clouds"]).all()
    assert int(sample["gt_box_present"].sum()) == 2
    # the val split samples rows of the prepared (axis-aligned) mesh
    prepared = np.load(tmp_path / "from_download" / f"{SCAN}_vert.npy")
    assert len(prepared) == len(verts)
    for p in sample["point_clouds"]:
        assert (prepared[:, :3] == p).all(1).any()
