"""The port's criterion against `vdetr_tpu.train.criterion.SetCriterion`.

Decoder-shaped predictions are built in both packages from the same
random head outputs through each package's `refine_box_predictions`
(three layers, layer 0 over all seeds with one bilabel class), against
synthetic ground truth repeated twice, with the exact JV matcher and with
the auction (the JAX default: the capacity auction for the repeated
jobs, the plain auction for the bilabel one). The full loss dict must
agree, and so must the loss's gradient with respect
to the head outputs, which runs back through the GIoU, the box
parametrization and every loss term. SUN RGB-D's 12 angle bins, with
rotated synthetic ground truth and nonzero angle costs in the matcher,
under `iou_type` giou (the rotated GIoU, kernel R's plain version here),
diou and iou, against the JAX criterion with its rotated overlaps guarded
against NaN gradients (`test_torch_rotated_iou.jax_guarded`: unguarded,
every JAX gradient of a rotated job is NaN).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetr_tpu.config import VDETRConfig as JaxConfig
from vdetr_tpu.data import ScannetDatasetConfig, SunrgbdDatasetConfig
from vdetr_tpu.models.transformer import \
    refine_box_predictions as jax_refine
from vdetr_tpu.train.criterion import SetCriterion as JaxCriterion
from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.data.dataset_config import \
    ScannetDatasetConfig as PortScannetConfig
from vdetr_tpu_torch.data.dataset_config import \
    SunrgbdDatasetConfig as PortSunrgbdConfig
from vdetr_tpu_torch.data.synthetic import SyntheticDetectionDataset, collate
from vdetr_tpu_torch.models.transformer import refine_box_predictions
from vdetr_tpu_torch.train.criterion import SetCriterion

from test_torch_rotated_iou import jax_guarded
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(repeat_num=2, matcher_impl="jv", is_bilable=True)
HEADS = ("sem_cls", "center", "size", "angle_cls", "angle_residual")
# f32 losses summed in other orders: ~1e-6 relative
LOSS_RTOL = 1e-5
# gradients of f32 sums over a few hundred pairs
GRAD_TOL = 1e-5


def make_case(seed=0, B=2, nseed=64, nq=24, nlayers=3, sunrgbd=False):
    rng = np.random.RandomState(seed)
    ds = PortSunrgbdConfig() if sunrgbd else PortScannetConfig()
    nbins = ds.num_angle_bin
    data = SyntheticDetectionDataset(ds, num_points=2048,
                                     num_scenes=B, max_objects=5, seed=seed)
    batch = collate([data[i] for i in range(B)])
    dmin, dmax = batch["point_cloud_dims_min"], batch["point_cloud_dims_max"]
    scene = (dmax - dmin)[:, None, :]
    layers = []
    for i in range(nlayers):
        n = nseed if i == 0 else nq
        ncls = 1 if i == 0 else ds.num_semcls
        centers = dmin[:, None, :] + rng.rand(B, n, 3) * scene
        sizes = rng.rand(B, n, 3) * 1.5 + 0.2
        layers.append(dict(
            heads={"sem_cls": rng.randn(B, n, ncls),
                   "center": 0.3 * rng.randn(B, n, 3),
                   "size": 0.3 * rng.randn(B, n, 3),
                   "angle_cls": rng.randn(B, n, nbins),
                   "angle_residual": rng.randn(B, n, nbins)},
            pre_center=(centers - dmin[:, None, :]) / scene,
            pre_size=sizes / scene))
    enc = dict(point_cls_logits=rng.randn(B, nseed, ds.num_semcls),
               seed_xyz=dmin[:, None, :] + rng.rand(B, nseed, 3) * scene)
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa
    return f32(layers), f32(enc), batch, sunrgbd


def _jax_value_and_grad(kw, sunrgbd):
    """The JAX criterion's loss dict and its gradient in the head outputs
    at KW + `kw`, jitted."""
    cfg = JaxConfig(**{**KW, **kw})
    ds = SunrgbdDatasetConfig() if sunrgbd else ScannetDatasetConfig()
    crit = JaxCriterion(cfg, ds)

    def f(heads, point_cls, anchors, seed_xyz, dims, targets):
        preds = [jax_refine(h, center, size, dims, ds.num_angle_bin, True)
                 for h, (center, size) in zip(heads, anchors)]
        out = {"outputs": preds[-1], "aux_outputs": preds[:-1],
               "enc_outputs": {"point_cls_logits": point_cls},
               "seed_xyz": seed_xyz}
        return crit(out, targets)

    return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))


def _jax_args(layers, enc, batch, sunrgbd):
    a = jnp.asarray
    return ([{k: a(L["heads"][k]) for k in HEADS} for L in layers],
            a(enc["point_cls_logits"]),
            [(a(L["pre_center"]), a(L["pre_size"])) for L in layers],
            a(enc["seed_xyz"]),
            [a(batch["point_cloud_dims_min"]),
             a(batch["point_cloud_dims_max"])],
            {k: a(v) for k, v in batch.items()})


def _key(kw, sunrgbd):
    return tuple(sorted(kw.items())), sunrgbd


SUN_COSTS = dict(matcher_anglecls_cost=0.5, matcher_anglereg_cost=0.5)
SUN_CASES = [("giou", "jv"), ("giou", "auction"), ("diou", "jv"),
             ("iou", "jv")]
CONFIGS = ([({}, False), ({"matcher_impl": "auction"}, False)]
           + [(dict(iou_type=i, matcher_impl=m, **SUN_COSTS), True)
              for i, m in SUN_CASES])


@pytest.fixture(scope="module")
def jax_criteria():
    """Every configuration's JAX criterion, traced here and compiled side
    by side (XLA compiles outside the interpreter lock), each program
    run by every case of its configuration: {`_key`: compiled}. JAX's
    rotated overlaps carry the port's guard against NaN gradients
    (tests/test_torch_rotated_iou.py); ScanNet's path never reaches
    them."""
    with jax_guarded():
        lowered = [_jax_value_and_grad(kw, sun).lower(*_jax_args(
            *make_case(2 if sun else 0, sunrgbd=sun))) for kw, sun in CONFIGS]
    with ThreadPoolExecutor(max_workers=len(lowered)) as pool:
        return dict(zip((_key(kw, sun) for kw, sun in CONFIGS),
                        pool.map(lambda f: f.compile(), lowered)))


def jax_loss(criteria, layers, enc, batch, sunrgbd, **kw):
    (loss, parts), grads = criteria[_key(kw, sunrgbd)](
        *_jax_args(layers, enc, batch, sunrgbd))
    return float(loss), jax.tree.map(float, parts), \
        jax.tree.map(np.asarray, grads)


def port_loss(layers, enc, batch, sunrgbd, **kw):
    cfg = VDETRConfig(**{**KW, **kw})
    ds = PortSunrgbdConfig() if sunrgbd else PortScannetConfig()
    crit = SetCriterion(cfg, ds)
    t = torch.from_numpy
    dims = [t(batch["point_cloud_dims_min"]), t(batch["point_cloud_dims_max"])]
    targets = {k: t(np.asarray(v)) for k, v in batch.items()}
    heads = [{k: t(L["heads"][k]).requires_grad_() for k in HEADS}
             for L in layers]
    point_cls = t(enc["point_cls_logits"]).requires_grad_()
    preds = [refine_box_predictions(h, t(L["pre_center"]), t(L["pre_size"]),
                                    dims, ds.num_angle_bin, True)
             for h, L in zip(heads, layers)]
    out = {"outputs": preds[-1], "aux_outputs": preds[:-1],
           "enc_outputs": {"point_cls_logits": point_cls},
           "seed_xyz": t(enc["seed_xyz"])}
    loss, parts = crit(out, targets)
    loss.backward()
    grads = ([{k: h[k].grad.numpy() for k in HEADS} for h in heads],
             point_cls.grad.numpy())
    return float(loss), {k: float(v) for k, v in parts.items()}, grads


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_dict_and_gradients_match_jax(seed, jax_criteria):
    check_against_jax(jax_criteria, make_case(seed))


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_dict_and_gradients_match_jax_auction(seed, jax_criteria):
    """The auction's assignments are JAX's bit for bit
    (tests/test_torch_matcher.py), so the losses meet the JV tolerances."""
    check_against_jax(jax_criteria, make_case(seed), matcher_impl="auction")


@pytest.mark.parametrize("iou_type,matcher", SUN_CASES)
def test_sunrgbd_loss_dict_and_gradients_match_jax(iou_type, matcher,
                                                   jax_criteria):
    """12 angle bins, rotated ground truth, nonzero angle matcher costs:
    the rotated GIoU (kernel R's plain version), or the differentiable
    DIoU / IoU, through the costs, the matching and every loss."""
    check_against_jax(jax_criteria, make_case(2, sunrgbd=True),
                      iou_type=iou_type, matcher_impl=matcher, **SUN_COSTS)


def check_against_jax(criteria, case, **kw):
    loss_j, parts_j, grads_j = jax_loss(criteria, *case, **kw)
    loss_p, parts_p, grads_p = port_loss(*case, **kw)
    assert loss_p == pytest.approx(loss_j, rel=LOSS_RTOL)
    assert set(parts_p) == set(parts_j)
    for k, v in parts_j.items():
        assert parts_p[k] == pytest.approx(v, rel=LOSS_RTOL, abs=1e-7), k
    for i, (gj, gp) in enumerate(zip(grads_j[0], grads_p[0])):
        for k in HEADS:
            np.testing.assert_allclose(
                gp[k], gj[k], rtol=0,
                atol=GRAD_TOL * max(np.abs(gj[k]).max(), 1e-6),
                err_msg=f"layer {i} {k}")
    np.testing.assert_allclose(grads_p[1], grads_j[1], rtol=0,
                               atol=GRAD_TOL * np.abs(grads_j[1]).max())


def test_refuses_the_unported_matcher_and_rotated_boxes():
    # every matcher of the JAX package is ported: an unknown one is refused
    with pytest.raises(ValueError):
        SetCriterion(VDETRConfig(matcher_impl="sinkhorn"),
                     PortScannetConfig())
    SetCriterion(VDETRConfig(), PortScannetConfig())  # the auction
    # rotated boxes are ported: an angle-binned dataset and every iou_type
    # are taken, the rotated GIoU where the dataset has angle bins
    assert not SetCriterion(VDETRConfig(), PortScannetConfig()).rotated
    for iou_type in ("giou", "diou", "iou"):
        crit = SetCriterion(VDETRConfig(iou_type=iou_type),
                            PortSunrgbdConfig())
        assert crit.rotated
