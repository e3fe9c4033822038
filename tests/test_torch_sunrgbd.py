"""The SUN RGB-D slice of the port against the JAX package, on the CPU.

- Rotated synthetic scenes (`data/synthetic.py` with an angle-binned
  config; not with `rotated=False`): every array equal to JAX's for the
  same seed and index.
- `SunrgbdDetectionDataset` on fabricated scans in VoteNet's layout
  (`<id>_pc.npz`, `<id>_bbox.npy`), train with its augmentations (colour
  ones too) and val, with and without colour: every field equal to JAX's
  from the same `np.random.RandomState` (tolerance 0: the same numpy
  arithmetic in the same order); the val split's subsample, which the
  port draws from `RandomState(index)`, equal to JAX's drawn from that.
- One tiny train step at `dataset_name="sunrgbd"`, `angle_type=
  "object_coords"` (the rotated vertex RPE) under the JV matcher and the
  auction, through the weight bridge: the loss, its terms and every
  gradient against `jax.value_and_grad` of the JAX model and criterion,
  its rotated overlaps guarded against NaN gradients
  (`test_torch_rotated_iou.jax_guarded`).
- The tiny eval step (`test_only`: yawed empty-box removal, then the
  device NMS on the rotated boxes' AABBs): outputs and keep mask against
  JAX `Trainer.eval_step`, then the AP with the device keep mask, with
  `rotated_nms` and with `angle_nms` against JAX's calculator.
- The CLI on fabricated SUN RGB-D scans (the port's mirror of
  tests/test_sunrgbd_e2e.py): one epoch with the oriented-box losses on,
  checkpoints, and `--test_only --auto_test` reproducing the final
  eval's mAP.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import (MODEL_ATOL, MODEL_RTOL, _random_tree,
                              flax_shapes)
from test_torch_rotated_iou import jax_guarded
from test_torch_train_step import _port_tree
from vdetr_tpu.config import VDETRConfig as JaxConfig
from vdetr_tpu.data.dataset_config import \
    ScannetDatasetConfig as JaxScannetConfig
from vdetr_tpu.data.dataset_config import \
    SunrgbdDatasetConfig as JaxSunConfig
from vdetr_tpu.data.sunrgbd import SunrgbdDetectionDataset as JaxSunrgbd
from vdetr_tpu.data.synthetic import SyntheticDetectionDataset as JaxSynth
from vdetr_tpu.eval import ap_calculator as jap
from vdetr_tpu.models import build_model as build_jax_model
from vdetr_tpu.parallel import make_mesh
from vdetr_tpu.train.criterion import SetCriterion as JaxCriterion
from vdetr_tpu.train.engine import Trainer as JaxTrainer
from vdetr_tpu.train.engine import TrainState
from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.convert import load_jax_params
from vdetr_tpu_torch.data.dataset_config import (ScannetDatasetConfig,
                                                 SunrgbdDatasetConfig)
from vdetr_tpu_torch.data.sunrgbd import SunrgbdDetectionDataset
from vdetr_tpu_torch.data.synthetic import SyntheticDetectionDataset, collate
from vdetr_tpu_torch.eval import ap_calculator as tap
from vdetr_tpu_torch.main import main
from vdetr_tpu_torch.models.vdetr import build_model as build_port_model
from vdetr_tpu_torch.train.engine import INPUT_KEYS, Trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TRAIN_IDS = [f"{i:06d}" for i in range(1, 5)]
VAL_IDS = ["000103", "000104"]
TINY = dict(
    dataset_name="sunrgbd", angle_type="object_coords",
    voxel_capacity=2048, min_stage_capacity=128, grid_extent=(128, 128, 64),
    voxel_size=0.05, preenc_npoints=128, nqueries=32, dec_nlayers=3,
    dec_dim=32, dec_ffn_dim=32, rpe_dim=16, inplanes=8, enc_dim=32,
    fps_impl="jax", num_points=1024, repeat_num=2, max_epoch=10,
    base_lr=1e-3, warm_lr_epochs=0, mlp_dropout=0.0, dec_dropout=0.0,
    loss_angle_cls_weight=0.1, loss_angle_reg_weight=0.5,
    matcher_anglecls_cost=0.5, matcher_anglereg_cost=0.5)
# tests/test_torch_train_step.py's tolerances: the loss and its terms
# are f32 sums in other orders (~1e-6 relative); each gradient within
# 1e-3 of its tensor's largest entry, rounding-noise gradients within
# 1e-6 of the largest of all
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-6


def write_sunrgbd(root, rng, n_points=3000):
    """VoteNet's SUN RGB-D layout: per scan `<id>_pc.npz` with `pc` (N, 6:
    xyz and colour centred on 0) and `<id>_bbox.npy` (K, 8: center, size,
    heading, class)."""
    for split, ids in (("train", TRAIN_IDS), ("val", VAL_IDS)):
        os.makedirs(root / split, exist_ok=True)
        for sid in ids:
            pc = np.concatenate(
                [rng.rand(n_points, 3) * [5, 5, 2.5] - [2.5, 2.5, 0],
                 rng.rand(n_points, 3) - 0.5], axis=1).astype(np.float32)
            nb = rng.randint(3, 6)
            boxes = np.zeros((nb, 8), np.float32)
            boxes[:, 0:3] = rng.rand(nb, 3) * 3 - 1.5
            boxes[:, 3:6] = rng.rand(nb, 3) * 0.8 + 0.3
            boxes[:, 6] = rng.rand(nb) * 2 * np.pi - np.pi
            boxes[:, 7] = rng.randint(0, 10, nb)
            np.savez(root / split / f"{sid}_pc.npz", pc=pc)
            np.save(root / split / f"{sid}_bbox.npy", boxes)


@pytest.fixture(scope="module")
def sun_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("sunrgbd")
    write_sunrgbd(root, np.random.RandomState(11))
    return root


def assert_same_sample(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("rotated", [None, False],
                         ids=["default", "axis-aligned"])
def test_rotated_synthetic_scenes_equal_jax(rotated):
    """SUN RGB-D's config rotates by default (and not when told not to);
    ScanNet's scenes stay as they were."""
    got = SyntheticDetectionDataset(SunrgbdDatasetConfig(), 2048,
                                    num_scenes=3, seed=5, rotated=rotated)
    want = JaxSynth(JaxSunConfig(), 2048, num_scenes=3, seed=5,
                    rotated=rotated)
    assert got.rotated == (rotated is None)
    for i in range(3):
        g = got[i]
        assert_same_sample(g, want[i])
        yaw = g["gt_box_angles"][g["gt_box_present"] > 0]
        assert (yaw != 0).all() if got.rotated else (yaw == 0).all()
    scan = SyntheticDetectionDataset(ScannetDatasetConfig(), 512, seed=5)
    assert not scan.rotated
    assert_same_sample(scan[0], JaxSynth(JaxScannetConfig(), 512, seed=5)[0])


@pytest.mark.parametrize("case", ["train", "train-color-aug", "train-xyz",
                                  "val"])
def test_sunrgbd_dataset_equals_jax(sun_root, case):
    kw = dict(dataset_root_dir=str(sun_root), num_points=2048,
              use_color=case != "train-xyz")
    if case == "train-color-aug":
        kw["coloraug_sunrgbd"] = True
    split = "val" if case == "val" else "train"
    got = SunrgbdDetectionDataset(VDETRConfig(**kw), SunrgbdDatasetConfig(),
                                  split)
    want = JaxSunrgbd(JaxConfig(**kw), JaxSunConfig(), split)
    assert got.sample_ids == want.sample_ids and len(got) == len(want)
    assert got.augment == (split == "train")
    for i in range(len(got)):
        # the port's val split subsamples from RandomState(index) whatever
        # generator it is given (repeatable eval passes); JAX's from the
        # generator: handed RandomState(index), it must give the same
        g = got.__getitem__(i, np.random.RandomState(i if split == "train"
                                                     else 100 + i))
        assert_same_sample(g, want.__getitem__(i, np.random.RandomState(i)))
        assert g["point_clouds"].shape == (2048, 6 if case != "train-xyz"
                                           else 3)


# --------------------------------------------------------------------------
# a train step through the weight bridge
# --------------------------------------------------------------------------

def _batch(n=2, seed=4):
    data = SyntheticDetectionDataset(SunrgbdDatasetConfig(), num_points=1024,
                                     num_scenes=n, max_objects=4, seed=seed)
    return collate([data[i] for i in range(n)])


def _jax_variables(seed):
    shapes = flax_shapes(VDETRConfig(**TINY), SunrgbdDatasetConfig())
    rng = np.random.RandomState(seed)
    return (_random_tree(shapes["params"], rng),
            _random_tree(shapes["batch_stats"], rng, stats=True))


def jax_train_refs():
    """JAX's loss and gradients under JV and the auction on the scenes of
    seed 4 and the weights of seed 5: (params, stats, {matcher: (loss,
    loss dict, gradients)}). The JAX model's forward is compiled once
    with its pullback as an output, the pullback once, and each
    criterion's value and gradient in the model's outputs apart (in one
    function the two criteria's backward passes through the model were
    compiled twice); those three compile side by side."""
    batch = _batch()
    inputs = {k: jnp.asarray(batch[k]) for k in INPUT_KEYS}
    targets = {k: jnp.asarray(v) for k, v in batch.items()}
    jds = JaxSunConfig()
    jcfg = JaxConfig(**TINY)
    jm = build_jax_model(jcfg, jds)
    params, stats = _jax_variables(5)
    crits = {m: JaxCriterion(jcfg.replace(matcher_impl=m), jds)
             for m in ("jv", "auction")}

    def forward(p):
        return jm.apply({"params": p, "batch_stats": stats}, inputs,
                        train=True, mutable=["batch_stats"])[0]

    out, pullback = jax.jit(lambda p: jax.vjp(forward, p))(params)

    def cotangent(g):
        return jax.tree.map(
            lambda x, d: d if jnp.issubdtype(x.dtype, jnp.floating)
            else np.zeros(x.shape, jax.dtypes.float0), out, g)

    with jax_guarded():
        lowered = [jax.jit(jax.value_and_grad(
            crit, has_aux=True, allow_int=True)).lower(out, targets)
            for crit in crits.values()]
    lowered.append(jax.jit(lambda f, cot: f(cot)[0]).lower(
        pullback, cotangent(out)))
    with ThreadPoolExecutor(max_workers=len(lowered)) as pool:
        *steps, pull = pool.map(lambda f: f.compile(), lowered)
    ref = {}
    for m, step in zip(crits, steps):
        (loss, parts), g = step(out, targets)
        ref[m] = (loss, parts, pull(pullback, cotangent(g)))
    return params, stats, ref


def jax_eval_step():
    """JAX's test_only `Trainer.eval_step` on the scenes of seed 6 and the
    weights of seed 7: (params, stats, outputs)."""
    batch = _batch(n=2, seed=6)
    jcfg = JaxConfig(**{**TINY, "test_only": True})
    jds = JaxSunConfig()
    jm = build_jax_model(jcfg, jds, axis_name="data")
    params, stats = _jax_variables(7)
    mesh = make_mesh(("data",), (1,), devices=jax.devices()[:1])
    jt = JaxTrainer(jcfg, jm, jds, mesh, steps_per_epoch=1)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=jt.tx.init(params))
    out = jt.eval_step(state, {k: jnp.asarray(batch[k]) for k in INPUT_KEYS},
                       retries=0)
    return params, stats, jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's side of the train-step and eval-step tests, side by side: the
    eval step traces and compiles in a thread while the train step's
    programs do here (XLA compiles outside the interpreter lock)."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        eval_step = pool.submit(jax_eval_step)
        return {"train": jax_train_refs(), "eval": eval_step.result()}


@pytest.fixture(scope="module")
def train_steps(jax_refs):
    """The port's train step under JV and the auction from JAX's
    weights, and JAX's loss and gradients under each."""
    params, stats, ref = jax_refs["train"]
    batch = _batch()
    cfg = VDETRConfig(**TINY)
    got = {}
    for m in ref:
        port = build_port_model(cfg, SunrgbdDatasetConfig(), device="cpu")
        load_jax_params(port, params, stats, cfg)
        tr = Trainer(cfg.replace(matcher_impl=m), port,
                     SunrgbdDatasetConfig(), steps_per_epoch=1, device="cpu")
        loss, parts = tr.train_step(batch, torch.Generator())
        grads, _ = _port_tree({n: p.grad for n, p in port.named_parameters()},
                              cfg)
        got[m] = (loss, {k: float(v) for k, v in parts.items()}, grads)
    return cfg, ref, got


@pytest.mark.parametrize("matcher", ["jv", "auction"])
def test_sunrgbd_train_step_matches_jax(train_steps, matcher):
    """The loss and its terms; every gradient (the port's after the 0.1
    global-norm clip, JAX's clipped here the same way)."""
    from vdetr_tpu.train.torch_import import _flatten

    cfg, ref, got = train_steps
    loss_j, parts_j, grads_j = ref[matcher]
    loss_p, parts_p, grads_p = got[matcher]
    assert np.isfinite(loss_p)
    assert loss_p == pytest.approx(float(loss_j), rel=LOSS_RTOL)
    assert set(parts_p) == set(parts_j)
    for k, v in parts_j.items():
        assert parts_p[k] == pytest.approx(float(v), rel=LOSS_RTOL,
                                           abs=1e-6), k
    assert parts_p["loss_angle_cls"] > 0 and parts_p["loss_angle_reg"] > 0
    grads_j = _flatten(jax.tree.map(np.asarray, grads_j))
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                        for g in grads_j.values()))
    scale = min(1.0, cfg.clip_gradient / gnorm)
    assert set(grads_p) == set(grads_j)
    top = max(np.abs(g).max() for g in grads_j.values()) * scale
    for k, want in grads_j.items():
        want = want * scale
        assert np.isfinite(grads_p[k]).all(), k
        np.testing.assert_allclose(
            grads_p[k], want, rtol=0,
            atol=max(GRAD_TOL * np.abs(want).max(), GRAD_FLOOR * top),
            err_msg=str(k))


# --------------------------------------------------------------------------
# the eval step and the AP
# --------------------------------------------------------------------------

def test_sunrgbd_eval_step_and_ap_match_jax(jax_refs):
    """The test_only eval step (yawed empty-box removal on every point at
    this size, then the device NMS): outputs within the forward's
    tolerance, the keep mask equal; then each AP variant's dict equal to
    JAX's calculator's on the same outputs (the device keep mask; the
    host's rotated NMS; the angle NMS)."""
    from test_torch_eval import _assert_same_keep

    batch = _batch(n=2, seed=6)
    inputs = {k: batch[k] for k in INPUT_KEYS}
    jcfg = JaxConfig(**{**TINY, "test_only": True})
    jds = JaxSunConfig()
    params, stats, want = jax_refs["eval"]

    cfg = VDETRConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(VDETRConfig)})
    port = build_port_model(cfg, SunrgbdDatasetConfig(), device="cpu")
    load_jax_params(port, params, stats, cfg)
    tr = Trainer(cfg, port, SunrgbdDatasetConfig(), steps_per_epoch=1,
                 device="cpu")
    assert tr.ap_config["remove_empty_box"]
    got = {k: v.numpy() for k, v in tr.eval_step(inputs).items()}
    assert set(got) == set(want) and "nms_keep" in got
    for k, v in want.items():
        if k != "nms_keep":
            np.testing.assert_allclose(got[k], v, rtol=MODEL_RTOL,
                                       atol=MODEL_ATOL, err_msg=k)
    _assert_same_keep(got, want)
    # the boxes are yawed: corners differ from the axis-aligned ones
    assert np.abs(want["box_corners"] - want["box_corners_axis_align"]
                  ).max() > 1e-3

    targets = {k: batch[k] for k in ("point_clouds", "gt_box_corners",
                                     "gt_box_sem_cls_label",
                                     "gt_box_present")}
    for variant in ({}, {"rotated_nms": True}, {"angle_nms": True}):
        aps = []
        for mod, ds, out in ((tap, SunrgbdDatasetConfig(), got),
                             (jap, jds, want)):
            c = mod.config_dict_from_cfg(cfg.replace(**variant), ds)
            if variant:
                assert not mod.device_nms_supported(c)
                out = {k: v for k, v in out.items() if k != "nms_keep"}
            kw = {"processes": 1} if mod is jap else {}
            calc = mod.APCalculator(ds, ap_iou_thresh=[0.25, 0.5],
                                    class2type_map=ds.class2type,
                                    ap_config_dict=c, **kw)
            calc.step(out, targets)
            aps.append(calc.metrics_to_dict(calc.compute_metrics()))
        assert aps[0] == aps[1], variant


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def test_sunrgbd_cli_train_eval_and_test_only(sun_root, tmp_path):
    """tests/test_sunrgbd_e2e.py's run on the port (object_coords here:
    the rotated RPE), then `--test_only --auto_test` on its checkpoint
    with the final eval's mAP (at --empty_pt_thre 0 the removal keeps
    every box, so the two passes compute the same function)."""
    ckpt = str(tmp_path / "ckpt")
    overall = main([
        "--dataset_name", "sunrgbd", "--dataset_root_dir", str(sun_root),
        "--voxel_capacity", "1024", "--min_stage_capacity", "128",
        "--preenc_npoints", "64", "--nqueries", "32",
        "--dec_nlayers", "2", "--dec_dim", "32", "--dec_ffn_dim", "32",
        "--rpe_dim", "8", "--inplanes", "8", "--enc_dim", "32",
        "--fps_impl", "jax", "--num_points", "2048", "--repeat_num", "2",
        "--mlp_dropout", "0", "--dec_dropout", "0",
        "--loss_angle_cls_weight", "0.1", "--loss_angle_reg_weight", "0.5",
        "--matcher_anglecls_cost", "0.5", "--angle_type", "object_coords",
        "--max_epoch", "1", "--eval_every_epoch", "10",
        "--batchsize_per_gpu", "2", "--dataset_num_workers", "0",
        "--checkpoint_dir", ckpt], device="cpu")
    assert 0.25 in overall and np.isfinite(overall[0.25]["mAP"])
    best = os.path.join(ckpt, "checkpoint_best")
    assert os.path.isfile(os.path.join(best, "state.pt"))
    again = main(["--dataset_name", "sunrgbd",
                  "--dataset_root_dir", str(sun_root), "--test_only", "1",
                  "--auto_test", "1", "--test_ckpt", best,
                  "--empty_pt_thre", "0", "--dataset_num_workers", "0"],
                 device="cpu")
    for t in (0.25, 0.5):
        assert again[t]["mAP"] == overall[t]["mAP"]
