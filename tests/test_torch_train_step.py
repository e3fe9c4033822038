"""One whole train step of the port against the JAX package, on the CPU.

A tiny configuration with dropout 0 and the exact JV matcher, random
weights from a numpy seed carried into the port through the weight
bridge, and two synthetic scenes. JAX: `jax.value_and_grad` of the flax
model in train mode plus `SetCriterion`, then the optax update of
`build_optimizer`. The port: `Trainer.train_step` (model, criterion,
backward, clip, AdamW) through its kernels' plain versions. Compared:
the total loss and every loss term, every parameter's gradient (after
the global-norm clip), the parameters after the AdamW step, and the
batch norms' running statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_model import _random_tree, flax_shapes
from vdetr_tpu.config import VDETRConfig as JaxConfig
from vdetr_tpu.data import ScannetDatasetConfig
from vdetr_tpu.models import build_model as build_jax_model
from vdetr_tpu.train.criterion import SetCriterion as JaxCriterion
from vdetr_tpu.train.optimizer import build_optimizer as jax_optimizer
from vdetr_tpu.train.schedule import make_lr_schedule
from vdetr_tpu.train.torch_import import _flatten, convert_torch_state_dict
from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.convert import KERNEL_OFFSET_PERMUTATION, load_jax_params
from vdetr_tpu_torch.data.dataset_config import \
    ScannetDatasetConfig as PortScannetConfig
from vdetr_tpu_torch.data.synthetic import SyntheticDetectionDataset, collate
from vdetr_tpu_torch.models.vdetr import build_model as build_port_model
from vdetr_tpu_torch.train.engine import INPUT_KEYS, Trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(
    voxel_capacity=2048, min_stage_capacity=128, grid_extent=(128, 128, 64),
    voxel_size=0.05, preenc_npoints=128, nqueries=32, dec_nlayers=3,
    dec_dim=32, dec_ffn_dim=32, rpe_dim=16, inplanes=8, enc_dim=32,
    fps_impl="jax", num_points=1024, repeat_num=2, max_epoch=10,
    base_lr=1e-3, warm_lr_epochs=0, mlp_dropout=0.0, dec_dropout=0.0,
    matcher_impl="jv")

# the loss: f32 sums in other orders through ~40 layers, ~1e-6 relative
LOSS_RTOL = 1e-4
# gradients: backpropagated through the same depth twice over, summed
# over up to ~2k voxels per weight: within 1e-3 of each tensor's largest
# entry. Gradients that are zero in exact arithmetic (a key bias under a
# softmax, a bias in front of a train-mode batch norm) are rounding
# noise, ~1e-10; they are held to 1e-6 of the largest gradient of all.
# A ReLU whose input lies within f32 rounding of 0 is a kink where the
# two frameworks may take different one-sided derivatives (the loss is
# not differentiable there); the data seed below has none.
GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-6
# running statistics: one momentum step from batch moments, ~1e-6
STATS_RTOL, STATS_ATOL = 1e-4, 1e-5


def _port_tree(named, cfg):
    """{port name: tensor} -> a flax params tree (the bridge's inverse,
    applied to gradients or parameters)."""
    sd = {}
    for name, v in named.items():
        v = v.detach().cpu().numpy()
        if name.endswith(".kernel") and v.shape[0] in \
                KERNEL_OFFSET_PERMUTATION:
            v = v[np.argsort(KERNEL_OFFSET_PERMUTATION[v.shape[0]])]
        sd[name] = v
    params, stats, _ = convert_torch_state_dict(sd, cfg)
    return _flatten(params), _flatten(stats)


def jax_update(jcfg, params, grads):
    """optax's first AdamW step of `build_optimizer` (its global-norm clip
    included), the gradients after that clip, and the step's learning
    rate: one compiled program (op by op, each leaf's shape compiled its
    own kernels)."""
    schedule = make_lr_schedule(jcfg, 1)
    tx = jax_optimizer(jcfg, schedule)

    @jax.jit
    def update(params, grads):
        updates, _ = tx.update(grads, tx.init(params), params)
        gnorm = optax.global_norm(grads)
        scale = jnp.where(gnorm >= jcfg.clip_gradient,
                          jcfg.clip_gradient / gnorm, 1.0)
        return (optax.apply_updates(params, updates),
                jax.tree.map(lambda g: g * scale, grads), schedule(0))

    return update(params, grads)


@pytest.fixture(scope="module")
def step():
    jcfg = JaxConfig(**TINY)
    cfg = VDETRConfig(**TINY)
    data = SyntheticDetectionDataset(PortScannetConfig(), num_points=1024,
                                     num_scenes=2, max_objects=4, seed=4)
    batch = collate([data[i] for i in range(2)])
    inputs = {k: jnp.asarray(batch[k]) for k in INPUT_KEYS}
    targets = {k: jnp.asarray(v) for k, v in batch.items()}

    jm = build_jax_model(jcfg, ScannetDatasetConfig())
    shapes = flax_shapes(cfg, PortScannetConfig())
    rng = np.random.RandomState(5)
    params = _random_tree(shapes["params"], rng)
    stats = _random_tree(shapes["batch_stats"], rng, stats=True)
    crit = JaxCriterion(jcfg, ScannetDatasetConfig())

    def loss_fn(p, s):
        out, mutated = jm.apply({"params": p, "batch_stats": s}, inputs,
                                train=True, mutable=["batch_stats"])
        loss, parts = crit(out, targets)
        return loss, (parts, mutated["batch_stats"])

    (loss, (parts, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, stats)
    new_params, clipped, lr = jax_update(jcfg, params, grads)
    ref = dict(loss=float(loss), parts=jax.tree.map(float, parts),
               grads=_flatten(jax.tree.map(np.asarray, clipped)),
               params=_flatten(jax.tree.map(np.asarray, new_params)),
               stats=_flatten(jax.tree.map(np.asarray, new_stats)),
               lr=float(lr))

    port = build_port_model(cfg, PortScannetConfig(), device="cpu")
    load_jax_params(port, params, stats, cfg)
    trainer = Trainer(cfg, port, PortScannetConfig(), steps_per_epoch=1,
                      device="cpu")
    p_loss, p_parts = trainer.train_step(batch, torch.Generator())
    grads_p, _ = _port_tree({n: p.grad for n, p in port.named_parameters()},
                            cfg)
    params_p, stats_p = _port_tree(port.state_dict(), cfg)
    got = dict(loss=p_loss, parts={k: float(v) for k, v in p_parts.items()},
               grads=grads_p, params=params_p, stats=stats_p)
    return cfg, ref, got


def test_loss_and_terms_match_jax(step):
    _, ref, got = step
    assert got["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
    assert set(got["parts"]) == set(ref["parts"])
    for k, v in ref["parts"].items():
        assert got["parts"][k] == pytest.approx(v, rel=LOSS_RTOL, abs=1e-6), k


def test_every_gradient_matches_jax(step):
    """After the 0.1 global-norm clip, which both apply."""
    _, ref, got = step
    assert set(got["grads"]) == set(ref["grads"])
    top = max(np.abs(g).max() for g in ref["grads"].values())
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(
            got["grads"][k], want, rtol=0,
            atol=max(GRAD_TOL * np.abs(want).max(), GRAD_FLOOR * top),
            err_msg=str(k))


def test_adamw_step_matches_optax(step):
    """AdamW's first step moves each weight by lr * (u + wd * w) with u =
    g / (|g| + eps). A gradient change d moves u by at most
    d / (|g| + eps) (and by at most 2), so with the gradients within the
    tolerance d of the test above, each parameter must be within lr *
    min(2, d / (|g| + eps)) plus f32 rounding of the update. A gradient
    that is zero in exact arithmetic gets the full +-lr of its sign."""
    _, ref, got = step
    lr = ref["lr"]
    top = max(np.abs(g).max() for g in ref["grads"].values())
    for k, want in ref["params"].items():
        g = ref["grads"][k]
        d = max(GRAD_TOL * np.abs(g).max(), GRAD_FLOOR * top)
        bound = lr * np.minimum(2.0, d / (np.abs(g) + 1e-8)) + 1e-6
        err = np.abs(got["params"][k] - want)
        assert (err <= bound).all(), (k, float((err - bound).max()))


def test_running_stats_match_jax(step):
    _, ref, got = step
    assert set(got["stats"]) == set(ref["stats"])
    for k, want in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k], want, rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=str(k))
