"""The port's criterion against `vdetr_tpu.train.criterion.SetCriterion`.

Decoder-shaped predictions are built in both packages from the same
random head outputs through each package's `refine_box_predictions`
(three layers, layer 0 over all seeds with one bilabel class), against
synthetic ground truth repeated twice, with the exact JV matcher. The
full loss dict must agree, and so must the loss's gradient with respect
to the head outputs, which runs back through the GIoU, the box
parametrization and every loss term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetr_tpu.config import VDETRConfig as JaxConfig
from vdetr_tpu.data import ScannetDatasetConfig
from vdetr_tpu.models.transformer import \
    refine_box_predictions as jax_refine
from vdetr_tpu.train.criterion import SetCriterion as JaxCriterion
from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.data.dataset_config import \
    ScannetDatasetConfig as PortScannetConfig
from vdetr_tpu_torch.data.synthetic import SyntheticDetectionDataset, collate
from vdetr_tpu_torch.models.transformer import refine_box_predictions
from vdetr_tpu_torch.train.criterion import SetCriterion

KW = dict(repeat_num=2, matcher_impl="jv", is_bilable=True)
HEADS = ("sem_cls", "center", "size", "angle_cls", "angle_residual")
# f32 losses summed in other orders: ~1e-6 relative
LOSS_RTOL = 1e-5
# gradients of f32 sums over a few hundred pairs
GRAD_TOL = 1e-5


def make_case(seed=0, B=2, nseed=64, nq=24, nlayers=3):
    rng = np.random.RandomState(seed)
    data = SyntheticDetectionDataset(PortScannetConfig(), num_points=2048,
                                     num_scenes=B, max_objects=5, seed=seed)
    batch = collate([data[i] for i in range(B)])
    dmin, dmax = batch["point_cloud_dims_min"], batch["point_cloud_dims_max"]
    scene = (dmax - dmin)[:, None, :]
    layers = []
    for i in range(nlayers):
        n = nseed if i == 0 else nq
        ncls = 1 if i == 0 else 18
        centers = dmin[:, None, :] + rng.rand(B, n, 3) * scene
        sizes = rng.rand(B, n, 3) * 1.5 + 0.2
        layers.append(dict(
            heads={"sem_cls": rng.randn(B, n, ncls),
                   "center": 0.3 * rng.randn(B, n, 3),
                   "size": 0.3 * rng.randn(B, n, 3),
                   "angle_cls": rng.randn(B, n, 1),
                   "angle_residual": rng.randn(B, n, 1)},
            pre_center=(centers - dmin[:, None, :]) / scene,
            pre_size=sizes / scene))
    enc = dict(point_cls_logits=rng.randn(B, nseed, 18),
               seed_xyz=dmin[:, None, :] + rng.rand(B, nseed, 3) * scene)
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa
    return f32(layers), f32(enc), batch


def jax_loss(layers, enc, batch):
    cfg = JaxConfig(**KW)
    crit = JaxCriterion(cfg, ScannetDatasetConfig())
    dims = [jnp.asarray(batch["point_cloud_dims_min"]),
            jnp.asarray(batch["point_cloud_dims_max"])]
    targets = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(heads, point_cls):
        preds = [jax_refine(h, jnp.asarray(L["pre_center"]),
                            jnp.asarray(L["pre_size"]), dims, 1, True)
                 for h, L in zip(heads, layers)]
        out = {"outputs": preds[-1], "aux_outputs": preds[:-1],
               "enc_outputs": {"point_cls_logits": point_cls},
               "seed_xyz": jnp.asarray(enc["seed_xyz"])}
        return crit(out, targets)

    heads = [{k: jnp.asarray(L["heads"][k]) for k in HEADS} for L in layers]
    (loss, parts), grads = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(
        heads, jnp.asarray(enc["point_cls_logits"]))
    return float(loss), jax.tree.map(float, parts), \
        jax.tree.map(np.asarray, grads)


def port_loss(layers, enc, batch):
    cfg = VDETRConfig(**KW)
    crit = SetCriterion(cfg, PortScannetConfig())
    t = torch.from_numpy
    dims = [t(batch["point_cloud_dims_min"]), t(batch["point_cloud_dims_max"])]
    targets = {k: t(np.asarray(v)) for k, v in batch.items()}
    heads = [{k: t(L["heads"][k]).requires_grad_() for k in HEADS}
             for L in layers]
    point_cls = t(enc["point_cls_logits"]).requires_grad_()
    preds = [refine_box_predictions(h, t(L["pre_center"]), t(L["pre_size"]),
                                    dims, 1, True)
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
def test_loss_dict_and_gradients_match_jax(seed):
    case = make_case(seed)
    loss_j, parts_j, grads_j = jax_loss(*case)
    loss_p, parts_p, grads_p = port_loss(*case)
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
    with pytest.raises(NotImplementedError):
        SetCriterion(VDETRConfig(), PortScannetConfig())  # the auction
    with pytest.raises(NotImplementedError):
        SetCriterion(VDETRConfig(matcher_impl="jv", iou_type="diou"),
                     PortScannetConfig())
