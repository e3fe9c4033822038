"""The port's data path and TTA against the JAX package on the CPU.

Fabricated ScanNet-format scans (no dataset needed, as in
tests/test_scannet_loader.py): `ScannetDetectionDataset` and
`RandomCuboid` must give JAX's sample from the same
`np.random.RandomState`, every field exact (tolerance 0: the same numpy
arithmetic in the same order), train and val, with and without colour
and its augmentations, scans longer and shorter than the point budget.
`prefetch_loader` (synchronous and threaded) and `make_loader` must give
JAX's batches and `sample_valid` with `pad_last`, and the AP calculator
must score each val scan once, the pad copies never. TTA's
`augment_batch`, `deaugment_outputs` and `merge_views` must give JAX's
arrays (tolerance 0).
"""

import numpy as np
import pytest
import torch

from vdetr_tpu.config import VDETRConfig as JaxConfig
from vdetr_tpu.data.loader import prefetch_loader as jax_prefetch
from vdetr_tpu.data.random_cuboid import RandomCuboid as JaxCuboid
from vdetr_tpu.data.scannet import ScannetDetectionDataset as JaxScannet
from vdetr_tpu.data.synthetic import SyntheticDetectionDataset as JaxSynth
from vdetr_tpu.data.synthetic import make_loader as jax_make_loader
from vdetr_tpu.eval import tta as jtta
from vdetr_tpu.data import ScannetDatasetConfig as JaxScannetConfig
from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.data.dataset_config import (ScannetDatasetConfig,
                                                 get_dataset_config)
from vdetr_tpu_torch.data.loader import prefetch_loader
from vdetr_tpu_torch.data.random_cuboid import RandomCuboid
from vdetr_tpu_torch.data.scannet import ScannetDetectionDataset
from vdetr_tpu_torch.data.synthetic import (SyntheticDetectionDataset,
                                            make_loader)
from vdetr_tpu_torch.eval import tta
from vdetr_tpu_torch.eval.ap_calculator import APCalculator
from vdetr_tpu_torch.geometry.boxes import rotate_aligned_boxes_np
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCANS = ["scene0000_00", "scene0001_00", "scene0002_00", "scene0003_00"]


def write_scans(root, rng, sizes, nboxes):
    """ScanNet-prep files: _vert (xyz + rgb), _bbox (cx..dz, nyu40 id),
    and the split lists; scans with no box are filt_empty's targets."""
    nyu = ScannetDatasetConfig().nyu40ids
    for name, n, nb in zip(SCANS, sizes, nboxes):
        xyz = rng.rand(n, 3) * [6, 5, 2.5]
        verts = np.concatenate([xyz, rng.rand(n, 3) * 255],
                               axis=1).astype(np.float32)
        boxes = np.zeros((nb, 7), np.float32)
        boxes[:, :3] = rng.rand(nb, 3) * [5, 4, 2] + 0.5
        boxes[:, 3:6] = rng.rand(nb, 3) * 0.8 + 0.3
        boxes[:, 6] = rng.choice(nyu, nb)
        np.save(root / f"{name}_vert.npy", verts)
        np.save(root / f"{name}_bbox.npy", boxes)
    (root / "scannetv2_train.txt").write_text("\n".join(SCANS) + "\n")
    (root / "scannetv2_val.txt").write_text("\n".join(SCANS[1:]) + "\n")


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet")
    write_scans(root, np.random.RandomState(0), [6000, 9000, 2500, 7000],
                [5, 9, 3, 0])
    return str(root)


COLOR = dict(use_color=True, color_drop=0.2, color_contrastp=0.5,
             color_jitterp=0.5, hue_sat="0.5_0.2_0.5")
CASES = {
    "xyz": dict(num_points=4000),
    "color_augs": dict(num_points=4000, **COLOR),
    "color_mean_no_cuboid": dict(num_points=4000, color_mean=0.5, **COLOR),
    "more_points_than_scans": dict(num_points=8000, **COLOR),
}


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scannet_sample_equals_jax(scans, split, case):
    kw = dict(dataset_root_dir=scans, **CASES[case])
    cuboid = case != "color_mean_no_cuboid"
    jds = JaxScannet(JaxConfig(**kw), JaxScannetConfig(), split,
                     use_random_cuboid=cuboid, random_cuboid_min_points=1000)
    pds = ScannetDetectionDataset(VDETRConfig(**kw), ScannetDatasetConfig(),
                                  split, use_random_cuboid=cuboid,
                                  random_cuboid_min_points=1000)
    assert pds.scan_names == jds.scan_names  # filt_empty drops scene0003
    for i in range(len(pds)):
        for seed in (0, 7):
            want = jds.__getitem__(i, rng=np.random.RandomState(seed))
            got = pds.__getitem__(i, rng=np.random.RandomState(seed))
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_random_cuboid_equals_jax():
    rng = np.random.RandomState(3)
    pc = (rng.rand(20000, 6) * [6, 5, 2.5, 1, 1, 1]).astype(np.float32)
    boxes = np.concatenate([rng.rand(6, 3) * [6, 5, 2.5], rng.rand(6, 4)],
                           axis=1).astype(np.float32)
    for seed in range(6):
        for min_points in (500, 15000):
            want = JaxCuboid(min_points)(pc, boxes,
                                         rng=np.random.RandomState(seed))
            got = RandomCuboid(min_points)(pc, boxes,
                                           rng=np.random.RandomState(seed))
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


def test_rotate_aligned_boxes_equals_jax():
    from vdetr_tpu.geometry.boxes import rotate_aligned_boxes_np as jax_rot

    rng = np.random.RandomState(4)
    boxes = rng.rand(9, 6).astype(np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    mat = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    np.testing.assert_array_equal(rotate_aligned_boxes_np(boxes, mat),
                                  jax_rot(boxes, mat))


def test_dataset_configs_equal_jax():
    from vdetr_tpu.data import get_dataset_config as jax_get

    for name in ("scannet", "synthetic", "sunrgbd"):
        got, want = get_dataset_config(name), jax_get(name)
        assert type(got).__name__ == type(want).__name__
        assert (got.num_semcls, got.num_angle_bin, got.max_num_obj) == (
            want.num_semcls, want.num_angle_bin, want.max_num_obj)
        assert getattr(got, "nyu40id2class", None) == getattr(
            want, "nyu40id2class", None)
        assert got.class2type == want.class2type
        np.testing.assert_array_equal(got.mean_size_arr, want.mean_size_arr)
        np.testing.assert_array_equal(got.mean_size_arr_hard_anchor,
                                      want.mean_size_arr_hard_anchor)
        if name != "sunrgbd":  # no angle bins: zeros
            r = np.arange(4, dtype=np.float32)
            np.testing.assert_array_equal(got.class2angle(0, r),
                                          want.class2angle(0, r))
    # SUN RGB-D's angle bins (tolerance 0: the same numpy arithmetic)
    got, want = get_dataset_config("sunrgbd"), jax_get("sunrgbd")
    rng = np.random.RandomState(0)
    angles = np.concatenate([rng.rand(64) * 4 * np.pi - 2 * np.pi,
                             np.arange(-12, 13) * np.pi / 6]).astype(
        np.float32)
    for a in angles:
        assert got.angle2class(a) == want.angle2class(a)
        c, res = got.angle2class(a)
        assert got.class2angle(c, res) == want.class2angle(c, res)
        assert got.class2angle(c, res, False) == want.class2angle(c, res,
                                                                  False)
    cls = rng.randint(0, 12, 50)
    res = (rng.rand(50) - 0.5).astype(np.float32)
    np.testing.assert_array_equal(got.class2anglebatch(cls, res),
                                  want.class2anglebatch(cls, res))
    box = rng.rand(5, 3).astype(np.float32)
    np.testing.assert_array_equal(
        got.box_parametrization_to_corners_np(box, box + 0.5, angles[:5]),
        want.box_parametrization_to_corners_np(box, box + 0.5, angles[:5]))


def synth_pair(n=5):
    ds, jds = ScannetDatasetConfig(), JaxScannetConfig()
    return (SyntheticDetectionDataset(ds, 512, num_scenes=n, seed=3),
            JaxSynth(jds, 512, num_scenes=n, seed=3))


def assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    return got


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle,pad_last", [(True, False), (False, True),
                                              (True, True)])
def test_prefetch_loader_equals_jax(workers, shuffle, pad_last):
    pds, jds = synth_pair()
    kw = dict(shuffle=shuffle, seed=11, pad_last=pad_last,
              num_workers=workers)
    got = assert_same_batches(prefetch_loader(pds, 2, **kw),
                              jax_prefetch(jds, 2, **kw))
    if pad_last:
        assert [b["sample_valid"].tolist() for b in got] == \
            [[True, True], [True, True], [True, False]]


@pytest.mark.parametrize("shuffle,pad_last", [(True, False), (False, True)])
def test_make_loader_equals_jax(shuffle, pad_last):
    pds, jds = synth_pair()
    kw = dict(shuffle=shuffle, seed=2, pad_last=pad_last)
    assert_same_batches(make_loader(pds, 2, **kw),
                        jax_make_loader(jds, 2, **kw))


def fake_outputs(batch, rng, K=16):
    B = batch["point_clouds"].shape[0]
    ds = ScannetDatasetConfig()
    centers = (batch["point_cloud_dims_min"][:, None, :]
               + rng.rand(B, K, 3) * 3).astype(np.float32)
    sizes = (rng.rand(B, K, 3) + 0.3).astype(np.float32)
    angles = np.zeros((B, K), np.float32)
    corners = ds.box_parametrization_to_corners_np(centers, sizes, angles)
    return {"box_corners": corners, "box_corners_axis_align": corners,
            "sem_cls_prob": rng.rand(B, K, 18).astype(np.float32),
            "objectness_prob": rng.rand(B, K).astype(np.float32),
            "angle_prob": np.zeros((B, K), np.float32),
            "center_unnormalized": centers, "size_unnormalized": sizes,
            "angle_continuous": (rng.rand(B, K) - 0.5).astype(np.float32)}


def test_pad_last_scenes_are_not_scored():
    """Five scenes at batch 2: three batches, the last holding one pad
    copy; the AP calculator keeps exactly the five real scans, in
    order."""
    pds, _ = synth_pair()
    calc = APCalculator(ScannetDatasetConfig())
    rng = np.random.RandomState(0)
    gts = []
    for batch in make_loader(pds, 2, shuffle=False, pad_last=True):
        calc.step(fake_outputs(batch, rng), batch)
        gts.extend(batch["gt_box_present"][batch["sample_valid"]].sum(1))
    assert calc.scan_cnt == 5
    assert [len(calc.gt_map_cls[i]) for i in range(5)] == \
        [int(g) for g in gts]
    overall = calc.compute_metrics()
    assert np.isfinite(overall[0.25]["mAP"])


def test_tta_functions_equal_jax():
    rng = np.random.RandomState(5)
    pds, _ = synth_pair(2)
    batch = next(make_loader(pds, 2, shuffle=False))
    outs_p, outs_j = [], []
    for fx, fy, rz in tta.DEFAULT_VIEWS + ((True, False, 0.4),):
        aug_p = tta.augment_batch(batch, fx, fy, rz)
        aug_j = jtta.augment_batch(batch, fx, fy, rz)
        for k in aug_j:
            np.testing.assert_array_equal(aug_p[k], aug_j[k], err_msg=k)
        out = fake_outputs(aug_p, rng)
        outs_p.append(tta.deaugment_outputs(out, fx, fy, rz))
        outs_j.append(jtta.deaugment_outputs(out, fx, fy, rz))
        for k in outs_j[-1]:
            np.testing.assert_array_equal(outs_p[-1][k], outs_j[-1][k],
                                          err_msg=k)
    merged_p, merged_j = tta.merge_views(outs_p), jtta.merge_views(outs_j)
    for k in merged_j:
        np.testing.assert_array_equal(merged_p[k], merged_j[k])
    assert tta.DEFAULT_VIEWS == jtta.DEFAULT_VIEWS


def test_tta_eval_step_runs_each_view_and_merges():
    """The port's tta_eval_step on a stand-in eval step that returns its
    input's points as box centers (tensors, as the trainer's do): every
    view's centers come back to the original frame."""
    pds, _ = synth_pair(2)
    batch = next(make_loader(pds, 2, shuffle=False))
    rng = np.random.RandomState(6)
    seen = []

    def step(b):
        seen.append(b["point_clouds"][:, :4, :3])
        out = fake_outputs(b, rng, K=4)
        out["center_unnormalized"] = b["point_clouds"][:, :4, :3].copy()
        return {k: torch.from_numpy(v) for k, v in out.items()}

    merged = tta.tta_eval_step(step, batch)
    assert len(seen) == len(tta.DEFAULT_VIEWS)
    want = np.concatenate([batch["point_clouds"][:, :4, :3]] * len(seen), 1)
    np.testing.assert_allclose(merged["center_unnormalized"], want,
                               atol=1e-6)
