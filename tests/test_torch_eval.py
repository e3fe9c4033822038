"""The port's eval step against the JAX package's, on the CPU: the NMS
(numpy family and the device mask's plain loop), the chunked empty-box
counts, the rotated IoU (numpy and native), `parse_predictions` in every
NMS branch and `APCalculator`, the whole `Trainer.eval_step` on the same
weights (at the published size too, marked `slow`), the loops
`train_one_epoch` and `evaluate`, and the quality-proof tool's harness.

JAX runs its own functions on the CPU; the port runs its kernels' plain
versions (kernel N's is the literal `while_loop`). Inputs come from
numpy seeds and are handed to both as numpy arrays.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import (MODEL_ATOL, MODEL_RTOL, _random_tree,
                              flax_shapes, make_inputs, tiny_config)
from vdetr_tpu.data import ScannetDatasetConfig
from vdetr_tpu.eval import ap_calculator as jap
from vdetr_tpu.eval import native as jnative
from vdetr_tpu.geometry import iou as jiou
from vdetr_tpu.geometry import nms as jnms
from vdetr_tpu.geometry.points_in_boxes import points_in_boxes_all
from vdetr_tpu.models import build_model as build_jax_model
from vdetr_tpu.parallel import make_mesh
from vdetr_tpu.train.engine import Trainer as JaxTrainer
from vdetr_tpu.train.engine import TrainState
from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.convert import load_jax_params
from vdetr_tpu_torch.data.dataset_config import \
    ScannetDatasetConfig as PortScannetConfig
from vdetr_tpu_torch.eval import ap_calculator as tap
from vdetr_tpu_torch.eval import native as tnative
from vdetr_tpu_torch.geometry import iou as tiou
from vdetr_tpu_torch.geometry import nms as tnms
from vdetr_tpu_torch.geometry.points_in_boxes import points_in_boxes_count
from vdetr_tpu_torch.models.vdetr import build_model as build_port_model
from vdetr_tpu_torch.tools.nms_cases import nms_cases
from vdetr_tpu_torch.train.engine import Trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

THR = 0.25  # the published nms_iou


# --------------------------------------------------------------------------
# NMS
# --------------------------------------------------------------------------

def jax_mask(aabbs, scores, classes, valid, old_type=False):
    f = jax.vmap(lambda a, s, c, v: jnms.nms_3d_samecls_mask(
        a, s, c, v, THR, old_type))
    return np.asarray(f(jnp.asarray(aabbs), jnp.asarray(scores),
                        jnp.asarray(classes), jnp.asarray(valid)))


def port_mask(aabbs, scores, classes, valid, old_type=False):
    return tnms.nms_3d_samecls_mask(
        torch.from_numpy(aabbs), torch.from_numpy(scores),
        torch.from_numpy(classes), torch.from_numpy(valid), THR,
        old_type).numpy()


@pytest.mark.parametrize("old_type", [False, True], ids=["iou", "old_type"])
@pytest.mark.parametrize("K", [40, 300])
def test_nms_mask_plain_matches_jax(rng, K, old_type):
    """Exact: the same f32 formula, and argmax's lowest index on ties in
    both. The cases hold exact score ties, pairs exactly at the
    threshold and holes in `valid` (tools/nms_cases.py)."""
    case = nms_cases(rng, 3, K)
    got = port_mask(*case, old_type=old_type)
    np.testing.assert_array_equal(got, jax_mask(*case, old_type=old_type))
    assert not (got & ~case[3]).any()


def test_nms_mask_ties_and_threshold_by_hand():
    """Two equal boxes of equal score: the lower index is kept, the other
    suppressed; a same-class pair at IoU exactly 0.25 is kept (the test is
    `> thr`), at 0.25 + one step of the lattice it is not; another class
    never suppresses."""
    boxes = np.array([[[0, 0, 0, 1, 1, 1],   # 0
                       [0, 0, 0, 1, 1, 1],   # 1: same as 0, same score
                       [4, 0, 0, 6, 1, 1],   # 2: area 2
                       [5, 0, 0, 8, 1, 1],   # 3: area 3, inter 1: IoU 1/4
                       [5, 0, 0, 7.5, 1, 1],  # 4: IoU 1/3.5 > 1/4
                       [0, 0, 0, 1, 1, 1]]],  # 5: as 0, another class
                     np.float32)
    scores = np.array([[0.5, 0.5, 0.9, 0.8, 0.7, 0.4]], np.float32)
    classes = np.array([[1, 1, 2, 2, 2, 3]], np.int32)
    valid = np.ones((1, 6), bool)
    want = np.array([[True, False, True, True, False, True]])
    for old_type, w in ((False, want),
                        # inter / area_j: 1/3 and 1/2.5 for boxes 3 and 4
                        (True, np.array([[True, False, True, False, False,
                                          True]]))):
        np.testing.assert_array_equal(
            port_mask(boxes, scores, classes, valid, old_type), w)
        np.testing.assert_array_equal(
            jax_mask(boxes, scores, classes, valid, old_type), w)


@pytest.mark.parametrize("old_type", [False, True], ids=["iou", "old_type"])
def test_nms_mask_plain_matches_numpy_picks(rng, old_type):
    """Against the reference's numpy NMS on the valid boxes, with distinct
    scores: np.argsort breaks ties toward another index than argmax, so
    ties are held to JAX alone (above). The threshold pairs are in."""
    aabbs, _, classes, valid = nms_cases(rng, 4, 200)
    scores = rng.permutation(4 * 200).reshape(4, 200).astype(np.float32)
    scores /= scores.max()
    got = port_mask(aabbs, scores, classes, valid, old_type)
    for b in range(4):
        ids = np.where(valid[b])[0]
        boxes = np.concatenate([aabbs[b, ids], scores[b, ids, None],
                                classes[b, ids, None]], axis=1)
        pick = jnms.nms_3d_faster_samecls_np(boxes, THR, old_type)
        want = np.zeros(200, bool)
        want[ids[pick]] = True
        np.testing.assert_array_equal(got[b], want)


def _numpy_nms_inputs(rng, n=60):
    lo = rng.randn(n, 3) * 2
    hi = lo + rng.rand(n, 3) * 2 + 0.1
    score = rng.rand(n)
    cls = rng.randint(0, 3, size=n).astype(float)
    return lo, hi, score, cls


@pytest.mark.parametrize("name,old_type", [
    ("nms_2d_faster_np", False), ("nms_2d_faster_np", True),
    ("nms_3d_faster_np", False), ("nms_3d_faster_np", True),
    ("nms_3d_faster_samecls_np", False), ("nms_3d_faster_samecls_np", True),
    ("nms_3d_rotated_samecls_np", False)])
def test_numpy_nms_family_matches_jax(rng, name, old_type):
    """The copies pick what the JAX package's numpy NMS picks, in order."""
    lo, hi, score, cls = _numpy_nms_inputs(rng)
    if name == "nms_2d_faster_np":
        args = (np.concatenate([lo[:, :2], hi[:, :2], score[:, None]], 1),
                THR, old_type)
    elif name == "nms_3d_faster_np":
        args = (np.concatenate([lo, hi, score[:, None]], 1), THR, old_type)
    elif name == "nms_3d_faster_samecls_np":
        args = (np.concatenate([lo, hi, score[:, None], cls[:, None]], 1),
                THR, old_type)
    else:
        ds = PortScannetConfig()
        corners = ds.box_parametrization_to_corners_np(
            (lo + hi) / 2, hi - lo, rng.rand(len(lo)) * np.pi)
        args = (corners, score, cls, THR)
    assert getattr(tnms, name)(*args) == getattr(jnms, name)(*args)


# --------------------------------------------------------------------------
# empty-box counts and the rotated IoU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 7, 64, 500, 4096])
def test_points_in_boxes_count_matches_jax(rng, chunk):
    """Exact: the same elementwise test, counted in int64, for chunks
    that split the points unevenly, in one piece and past the end."""
    pts = (rng.rand(2, 500, 3) * [3, 3, 2]).astype(np.float32)
    boxes = np.concatenate([rng.rand(2, 40, 3) * [3, 3, 1],
                            0.2 + rng.rand(2, 40, 3) * 1.5,
                            rng.rand(2, 40, 1) * np.pi], -1).astype(np.float32)
    want = np.asarray(points_in_boxes_all(jnp.asarray(pts),
                                          jnp.asarray(boxes)).sum(axis=1))
    got = points_in_boxes_count(torch.from_numpy(pts),
                                torch.from_numpy(boxes), chunk=chunk)
    assert got.dtype == torch.int64 and (got > 0).any()
    np.testing.assert_array_equal(got.numpy(), want)


def _rotated_corner_pairs(rng, n):
    ds = PortScannetConfig()
    c = rng.rand(2, n, 3) * 2
    c[1] = c[0] + rng.randn(n, 3) * 0.3  # overlapping partners
    return ds.box_parametrization_to_corners_np(
        c, 0.3 + rng.rand(2, n, 3), rng.rand(2, n) * 2 * np.pi)


def test_box3d_iou_np_matches_jax(rng):
    """The numpy copy is the JAX package's function: equal results."""
    a, b = _rotated_corner_pairs(rng, 40)
    got = [tiou.box3d_iou_np(a[i], b[i]) for i in range(40)]
    want = [jiou.box3d_iou_np(a[i], b[i]) for i in range(40)]
    assert got == want
    assert any(g[0] > 0 for g in got)


def test_native_iou_matches_jax_native(rng):
    """The port's native library, built from its own copy of the source
    into build/kernels/, against the JAX package's build of the same
    source (exact) and the numpy IoU (f32 output, 1e-5)."""
    a, b = _rotated_corner_pairs(rng, 30)
    got = tnative.box3d_iou_pairs(a, b)
    assert got is not None, "g++ could not build the port's native IoU"
    assert tnative.lib_path().parent.name == "kernels"
    assert tnative.iou_path().startswith("native")
    want = jnative.box3d_iou_pairs(a, b)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    ref = np.array([[tiou.box3d_iou_np(a[i], b[j])[0] for j in range(30)]
                    for i in range(30)])
    np.testing.assert_allclose(got, ref, atol=1e-5)


# --------------------------------------------------------------------------
# parse_predictions and the AP calculator
# --------------------------------------------------------------------------

def _predictions(rng, B=3, K=24, N=400):
    ds = PortScannetConfig()
    center = np.concatenate([rng.rand(B, K, 2) * 3, rng.rand(B, K, 1)], -1)
    size = 0.3 + rng.rand(B, K, 3) * 1.2
    angle = np.where(rng.rand(B, K) < 0.5, 0.0, rng.rand(B, K) * np.pi)
    corners = ds.box_parametrization_to_corners_np(center, size, angle)
    corners_aa = ds.box_parametrization_to_corners_np(center, size,
                                                      np.zeros_like(angle))
    sem = rng.rand(B, K, ds.num_semcls).astype(np.float32)
    sem[..., :3] *= 4  # three classes dominate: NMS has same-class pairs
    out = {"box_corners": corners, "box_corners_axis_align": corners_aa,
           "sem_cls_prob": sem,
           "objectness_prob": rng.rand(B, K).astype(np.float32),
           "angle_prob": rng.rand(B, K).astype(np.float32),
           "center_unnormalized": center.astype(np.float32),
           "size_unnormalized": size.astype(np.float32),
           "angle_continuous": angle.astype(np.float32)}
    pc = np.concatenate([rng.rand(B, N, 2) * 3, rng.rand(B, N, 1)],
                        -1).astype(np.float32)
    # ground truth: a few of the predicted boxes, moved a little
    G = 6
    gt = corners[:, :G] + rng.randn(B, G, 1, 3).astype(np.float32) * 0.05
    targets = {"point_clouds": pc, "gt_box_corners": gt.astype(np.float32),
               "gt_box_sem_cls_label": sem[:, :G].argmax(-1),
               "gt_box_present": (rng.rand(B, G) < 0.8).astype(np.float32),
               "sample_valid": np.array([True, False, True][:B])}
    return out, targets


BRANCHES = {
    "class-aware": {}, "keep-empty": dict(remove_empty_box=False),
    "class-agnostic": dict(cls_nms=False), "2d": dict(use_3d_nms=False),
    "no-nms": dict(no_nms=True), "rotated": dict(rotated_nms=True),
    "old-type": dict(use_old_type_nms=True), "angle-nms": dict(angle_nms=True),
    "angle-conf": dict(angle_conf=True),
    "cls-only": dict(per_class_proposal=False, use_cls_confidence_only=True),
    "obj-score": dict(per_class_proposal=False),
    "conf-thresh": dict(conf_thresh=0.3),
    "precomputed": dict(remove_empty_box=False),
    # the device mask holds the removal: the port skips the host's
    "precomputed-removal": {},
}


def _same_preds(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) and len(w) > 0
        for (gc, gb, gs), (wc, wb, ws) in zip(g, w):
            assert gc == wc and gs == ws
            np.testing.assert_array_equal(gb, wb)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_parse_predictions_and_ap_match_jax(rng, branch):
    """Exact: the same numpy code on the same arrays, in every NMS branch
    (the precomputed branch with a keep mask from the plain device NMS),
    then `APCalculator.step` (with `sample_valid`) and `compute_metrics`
    at 0.25 and 0.5."""
    out, targets = _predictions(rng)
    if branch.startswith("precomputed"):
        aabbs = np.concatenate([out["box_corners"].min(2),
                                out["box_corners"].max(2)], -1)
        out["nms_keep"] = port_mask(
            aabbs.astype(np.float32), out["objectness_prob"],
            out["sem_cls_prob"].argmax(-1).astype(np.int32),
            np.ones(out["objectness_prob"].shape, bool))
    kw = BRANCHES[branch]
    tcfg = tap.get_ap_config_dict(PortScannetConfig(), **kw)
    jcfg = jap.get_ap_config_dict(ScannetDatasetConfig(), **kw)
    csa = np.concatenate([out["center_unnormalized"],
                          out["size_unnormalized"],
                          out["angle_continuous"][..., None]], -1)
    args = (out["box_corners"], out["sem_cls_prob"], out["objectness_prob"],
            out["angle_prob"], targets["point_clouds"])
    mask = out.get("nms_keep")
    _same_preds(tap.parse_predictions(*args, tcfg, predicted_boxes_CSA=csa,
                                      precomputed_nms_mask=mask),
                jap.parse_predictions(*args, jcfg, predicted_boxes_CSA=csa,
                                      precomputed_nms_mask=mask))

    calcs = []
    for mod, cfg, ds in ((tap, tcfg, PortScannetConfig()),
                         (jap, jcfg, ScannetDatasetConfig())):
        # the JAX calculator's per-class loop in one process, as the
        # port's always is
        kw = {"processes": 1} if mod is jap else {}
        calc = mod.APCalculator(ds, ap_iou_thresh=[0.25, 0.5],
                                class2type_map=ds.class2type,
                                ap_config_dict=cfg, **kw)
        # the port's calculator takes tensors and copies them itself
        calc.step({k: torch.from_numpy(np.asarray(v)) for k, v in
                   out.items()} if mod is tap else out, targets)
        calcs.append(calc)
    assert calcs[0].scan_cnt == calcs[1].scan_cnt == 2
    got, want = (c.compute_metrics() for c in calcs)
    assert got == want
    assert got[0.25]["mAP"] > 0
    assert (calcs[0].metrics_to_dict(got) == calcs[1].metrics_to_dict(want))
    assert calcs[0].metrics_to_str(got) == calcs[1].metrics_to_str(want)


@pytest.mark.parametrize("size", ["", "S", "M", "L"])
def test_eval_det_matches_jax(rng, size):
    """The port's one-process per-class AP equals the JAX package's
    `eval_det` on the same scans (every class's rec, prec and AP, exactly),
    in each volume bucket, at both IoU thresholds."""
    from vdetr_tpu.eval.eval_det import eval_det as jax_eval_det
    from vdetr_tpu_torch.eval.eval_det import eval_det

    out, targets = _predictions(rng)
    calc = tap.APCalculator(PortScannetConfig(), ap_iou_thresh=[0.25])
    calc.step(out, targets)
    for thresh in (0.25, 0.5):
        got = eval_det(calc.pred_map_cls, calc.gt_map_cls,
                       ovthresh=thresh, size=size)
        want = jax_eval_det(calc.pred_map_cls, calc.gt_map_cls,
                            ovthresh=thresh, size=size)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for c in g:
                np.testing.assert_array_equal(g[c], w[c])
    assert size or max(got[2].values()) > 0


def test_device_nms_predicates_match_jax():
    ds, jds = PortScannetConfig(), ScannetDatasetConfig()
    for kw in BRANCHES.values():
        t, j = (tap.get_ap_config_dict(ds, **kw),
                jap.get_ap_config_dict(jds, **kw))
        assert tap.device_nms_variant_ok(t) == jap.device_nms_variant_ok(j)
        assert tap.device_nms_supported(t) == jap.device_nms_supported(j)
    for test_only in (False, True):
        cfg = VDETRConfig(test_only=test_only)
        t = tap.config_dict_from_cfg(cfg, ds)
        j = jap.config_dict_from_cfg(tiny_config(test_only=test_only), jds)
        assert ({k: v for k, v in t.items() if k != "dataset_config"}
                == {k: v for k, v in j.items() if k != "dataset_config"})


# --------------------------------------------------------------------------
# the whole eval step
# --------------------------------------------------------------------------

def _eval_steps(jcfg, inputs, subsample=None, before_port=None):
    """(JAX `Trainer.eval_step` outputs, the port's, the port trainer) for
    the JAX config `jcfg` on the same random weights (numpy seed, through
    the weight bridge). `subsample`, if given, is the empty-box removal's
    point subset the port's trainer takes for this scan size;
    `before_port(jax model, variables, batch)`, if given, runs between
    the two steps."""
    cfg = VDETRConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(VDETRConfig)}
                      ).replace(matcher_impl="jv")  # the criterion's only
    jds = ScannetDatasetConfig()
    jm = build_jax_model(jcfg, jds, axis_name="data")
    batch = {k: jnp.asarray(v) for k, v in inputs.items()}
    shapes = flax_shapes(cfg, PortScannetConfig())
    rng = np.random.RandomState(1)
    params = _random_tree(shapes["params"], rng)
    stats = _random_tree(shapes["batch_stats"], rng, stats=True)
    mesh = make_mesh(("data",), (1,), devices=jax.devices()[:1])
    jt = JaxTrainer(jcfg, jm, jds, mesh, steps_per_epoch=1)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=jt.tx.init(params))
    want = jax.tree.map(np.asarray, jt.eval_step(state, batch, retries=0))
    if before_port is not None:
        before_port(jm, {"params": params, "batch_stats": stats}, batch)

    port = build_port_model(cfg, PortScannetConfig(), device="cpu")
    load_jax_params(port, params, stats, cfg)
    trainer = Trainer(cfg, port, PortScannetConfig(), steps_per_epoch=1,
                      device="cpu")
    if subsample is not None:
        n = inputs["point_clouds"].shape[1]
        trainer._subsample[n] = torch.from_numpy(np.array(subsample)).long()
    got = {k: v.numpy() for k, v in trainer.eval_step(inputs).items()}
    return want, got, trainer


@pytest.mark.parametrize("test_only", [False, True],
                         ids=["train-loop-eval", "test_only"])
def test_eval_step_matches_jax(test_only):
    """Outputs within the forward's tolerance (f32 through ~40 layers in
    other orders: 1e-4), the keep mask equal, and the AP dicts of the two
    calculators equal. test_only turns on the empty-box removal: at 512
    points the subsample is every point, in another order, in both."""
    inputs = make_inputs(seed=3, N=512)
    want, got, trainer = _eval_steps(tiny_config(test_only=test_only),
                                     inputs)
    assert trainer.ap_config["remove_empty_box"] == test_only
    assert set(got) == set(want) and "nms_keep" in got
    for k, v in want.items():
        if k != "nms_keep":
            np.testing.assert_allclose(got[k], v, rtol=MODEL_RTOL,
                                       atol=MODEL_ATOL, err_msg=k)
    _assert_same_keep(got, want)
    assert got["nms_keep"].any(1).all()

    # ground truth: each scene's five most objectness-confident boxes
    top = np.argsort(-want["objectness_prob"], axis=1)[:, :5]
    take = np.take_along_axis
    targets = {
        "point_clouds": inputs["point_clouds"],
        "gt_box_corners": take(want["box_corners"], top[..., None, None], 1),
        "gt_box_sem_cls_label": take(want["sem_cls_prob"].argmax(-1), top,
                                     1),
        "gt_box_present": np.ones(top.shape, np.float32)}
    ap = []
    for mod, ds, out in ((tap, PortScannetConfig(), got),
                         (jap, ScannetDatasetConfig(), want)):
        cfg = mod.config_dict_from_cfg(trainer.cfg, ds)
        kw = {"processes": 1} if mod is jap else {}
        calc = mod.APCalculator(ds, ap_iou_thresh=[0.25, 0.5],
                                class2type_map=ds.class2type,
                                ap_config_dict=cfg, **kw)
        calc.step(out, targets)
        ap.append(calc.metrics_to_dict(calc.compute_metrics()))
    assert ap[0] == ap[1]
    assert ap[0]["mAP_0.25"] > 0


# the layer-0 objectness of the published model agrees to 3.6e-7 between
# the frameworks (f32 through the backbone, FPN and first FFN); two
# proposals closer than this may rank either way
TIE = 1e-6


@pytest.mark.slow
def test_published_eval_step_matches_jax(monkeypatch):
    """The published config (`VDETRConfig()`) on one synthetic 100k-point
    scene, the same random weights: the port's eval step on the CPU (plain
    versions) against JAX's. Outputs within 1e-3 (f32 through 34 sparse
    convs over ~10^5 voxels and 8 decoder layers, summed in other
    orders), the keep mask equal (`_assert_same_keep`).

    The top-1024 proposal choice ranks 4096 layer-0 scores, and two of
    them may lie closer than the frameworks' rounding apart (on this
    scene seeds 194 and 1591, 0.73974675 and 0.7397468 in JAX, one ulp,
    and equal in the port). Such a near-tie is resolved JAX's way: the
    port's `select_proposals` is handed `lax.top_k` of JAX's layer-0
    objectness, after checking that the port's own choice differs from
    it only at positions whose two proposals score within TIE of each
    other in the port. A difference past TIE fails. `test_only` is off:
    past 40000 points the empty-box subsample is a different random
    subset in each framework; tests/test_torch_eval_subsample.py holds
    the removal to JAX past 40000 points on JAX's subset. Minutes of CPU
    time and several GiB:
    `python -m pytest tests/test_torch_eval.py -m slow`."""
    from vdetr_tpu.config import VDETRConfig as JaxConfig
    from vdetr_tpu_torch.data.synthetic import (SyntheticDetectionDataset,
                                                collate)
    from vdetr_tpu_torch.models import transformer

    data = SyntheticDetectionDataset(PortScannetConfig(), num_points=100000,
                                     num_scenes=1, seed=0)
    b = collate([data[0]])
    inputs = {k: b[k] for k in ("point_clouds", "point_validity",
                                "point_cloud_dims_min",
                                "point_cloud_dims_max")}
    seen, own_choice = {}, transformer.select_proposals

    def jax_choice(jm, variables, batch):
        obj0 = jax.jit(lambda v, i: jm.apply(v, i, train=False)[
            "aux_outputs"][0]["objectness_prob"])(variables, batch)
        obj0 = torch.from_numpy(np.array(obj0))

        def choose(obj, nq):
            own = own_choice(obj, nq)
            masked = torch.where(torch.isinf(obj), obj, obj0)
            theirs = torch.from_numpy(np.array(jax.lax.top_k(
                jnp.asarray(masked.numpy()), nq)[1])).long()
            seen.update(own=own, theirs=theirs, obj=obj, obj0=masked)
            return theirs

        monkeypatch.setattr(transformer, "select_proposals", choose)

    want, got, _ = _eval_steps(JaxConfig(), inputs, before_port=jax_choice)
    own, theirs, obj = seen["own"], seen["theirs"], seen["obj"]
    # what the run saw (shown with -s): the layer-0 scores' agreement,
    # the tied choices and the largest error of each output
    print(f"\nlayer-0 objectness, max |port - JAX| "
          f"{float((obj - seen['obj0']).abs().max()):.3e}")
    for bi, q in zip(*np.nonzero((own != theirs).numpy())):
        a, c = int(own[bi, q]), int(theirs[bi, q])
        gap = float((obj[bi, a] - obj[bi, c]).abs())
        print(f"query {q}: port seed {a}, JAX seed {c}; port scores "
              f"{float(obj[bi, a]):.8f} {float(obj[bi, c]):.8f}, JAX "
              f"{float(seen['obj0'][bi, a]):.8f} "
              f"{float(seen['obj0'][bi, c]):.8f}")
        assert gap <= TIE, (bi, q, a, c, gap)
    for k, v in want.items():
        err = (int((got[k] != v).sum()) if k == "nms_keep"
               else float(np.abs(got[k].astype(np.float64) - v).max()))
        print(f"{k}: {'flags differing' if k == 'nms_keep' else 'max err'} "
              f"{err}")
    for k, v in want.items():
        if k != "nms_keep":
            np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-3,
                                       err_msg=k)
    _assert_same_keep(got, want, tol=1e-3)


def _assert_same_keep(got, want, tol=MODEL_ATOL):
    """The keep masks are equal. Where they are not, the test fails
    unless every box that differs has a score within the output
    tolerance of another box of its scene and class: a rounding-level tie
    that the two frameworks may order either way."""
    diff = got["nms_keep"] != want["nms_keep"]
    if not diff.any():
        return
    obj, cls = want["objectness_prob"], want["sem_cls_prob"].argmax(-1)
    for b, k in zip(*np.nonzero(diff)):
        others = [j for j in range(obj.shape[1])
                  if j != k and cls[b, j] == cls[b, k]]
        gap = min(abs(obj[b, j] - obj[b, k]) for j in others)
        assert gap <= tol + MODEL_RTOL * obj[b, k], (b, k, gap)


def test_train_one_epoch_and_evaluate_loops():
    """The loops around the two steps on a small model: one epoch of two
    train steps (the mean loss, the last loss dict, the logger and the
    metrics logger at their intervals, the step count), then `evaluate`
    over the same batches into an `APCalculator` (every scene counted,
    metrics finite)."""
    from vdetr_tpu_torch.data.synthetic import (SyntheticDetectionDataset,
                                                collate)
    from vdetr_tpu_torch.train.engine import evaluate, train_one_epoch

    cfg = VDETRConfig(
        voxel_capacity=2048, min_stage_capacity=128,
        grid_extent=(128, 128, 64), preenc_npoints=128, nqueries=32,
        dec_nlayers=2, dec_dim=32, dec_ffn_dim=32, rpe_dim=16, inplanes=8,
        enc_dim=32, num_points=1024, voxel_size=0.05, matcher_impl="jv",
        max_epoch=2, warm_lr_epochs=0)
    ds = PortScannetConfig()
    data = SyntheticDetectionDataset(ds, cfg.num_points, num_scenes=4,
                                     max_objects=4)
    loader = [collate([data[0], data[1]]), collate([data[2], data[3]])]
    trainer = Trainer(cfg, build_port_model(cfg, ds, device="cpu"), ds,
                      steps_per_epoch=2, device="cpu")
    lines, logged = [], []

    class Metrics:
        def log(self, values, step, prefix):
            logged.append((prefix, step, values))

    mean, last = train_one_epoch(trainer, loader, epoch=0,
                                 generator=torch.Generator(),
                                 log_every=1, logger=lines.append,
                                 metrics_logger=Metrics(),
                                 log_metrics_every=2)
    assert trainer.step == 2 and np.isfinite(mean)
    assert set(last) >= {"loss_giou", "loss_sem_cls"}
    assert len(lines) == 2 and lines[0].startswith("Epoch [0]; Iter [0]")
    assert [(p, s) for p, s, _ in logged] == [("train_iter/", 1)]
    assert np.isfinite(logged[0][2]["loss"])

    calc = tap.APCalculator(ds, ap_iou_thresh=[0.25, 0.5],
                            class2type_map=ds.class2type,
                            ap_config_dict=trainer.ap_config)
    assert evaluate(trainer, loader, calc, logger=None) is calc
    assert calc.scan_cnt == 4
    metrics = calc.metrics_to_dict(calc.compute_metrics())
    assert all(np.isfinite(float(v)) for v in metrics.values())


# --------------------------------------------------------------------------
# the quality proof's harness
# --------------------------------------------------------------------------

def test_quality_proof_tiny_on_cpu(tmp_path, monkeypatch):
    """`--tiny --device cpu`: two train steps and one eval pass write a
    well-formed JSON (the reduced config patched smaller still)."""
    from vdetr_tpu_torch.tools import quality_proof as qp

    monkeypatch.setattr(qp, "TINY", dict(
        voxel_capacity=2048, min_stage_capacity=128,
        grid_extent=(512, 512, 256), preenc_npoints=128, nqueries=32,
        dec_nlayers=2, inplanes=8, num_points=2048))
    out = tmp_path / "q.json"
    qp.main(["--tiny", "--device", "cpu", "--steps", "2", "--eval_every",
             "2", "--scenes", "2", "--batch", "1", "--out", str(out)])
    res = json.loads(out.read_text())
    assert res["finished"] and res["steps_done"] == 2
    assert res["device"] == "cpu" and res["config"]["matcher_impl"] == "auction"
    (rec,) = res["trajectory"]
    assert rec["step"] == 2 and np.isfinite(rec["loss"])
    for k in ("mAP25", "mAP50", "AR25", "AR50"):
        assert 0.0 <= rec[k] <= 100.0
    assert rec["iou_path"].startswith("native")
    assert res["train_ms_per_step_median"] > 0
