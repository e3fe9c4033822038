"""The JAX model's configurations beyond the published one, in the port
against the JAX package on the CPU.

- `GenericMLP`'s norms (None, "id", "ln", "bn1d") and activations
  ("relu", "gelu" in flax's tanh form, "leakyrelu" at slope 0.1), in
  train and eval mode, module by module; the Fourier and sine coordinate
  embeddings; `ShareSelfAttention`.
- One tiny model with every decoder and head flag the JAX model has
  (`pos_for_key`, `share_selfattn`, `querypos_mlp=False`, `mlp_norm="ln"`,
  `mlp_act="gelu"`) on the Bottleneck backbone (depth 50): one train
  step at dropout 0 under the exact JV matcher, the JAX package's
  `jax.value_and_grad` of model and criterion against the port's model,
  criterion and backward, on the same numpy-seeded weights through the
  weight bridge. Compared: the loss and its terms, the train-mode
  forward's predictions, every gradient, every running statistic.
- The parameter trees of depths 101 and 152 (`jax.eval_shape` of init,
  no compute) load into the port and come back equal, leaf by leaf.
- `random_fps`: in eval mode the output equals `random_fps=False` bit for
  bit; in train mode FPS picks, on the permuted voxels, what JAX's
  `furthest_point_sample` picks on the same permutation.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import _random_tree, flax_shapes, make_inputs
from test_torch_train_step import (GRAD_FLOOR, GRAD_TOL, LOSS_RTOL,
                                   STATS_ATOL, STATS_RTOL, TINY)
from vdetr_tpu.config import VDETRConfig as JaxConfig
from vdetr_tpu.data import ScannetDatasetConfig
from vdetr_tpu.models import build_model as build_jax_model
from vdetr_tpu.models.mlp import GenericMLP as JaxMLP
from vdetr_tpu.models.position_embedding import \
    PositionEmbeddingCoordsSine as JaxPosSine
from vdetr_tpu.models.transformer import \
    ShareSelfAttention as JaxShareSelfAttention
from vdetr_tpu.ops.fps import furthest_point_sample as jax_fps
from vdetr_tpu.train.criterion import SetCriterion as JaxCriterion
from vdetr_tpu.train.torch_import import _flatten
from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.convert import jax_trees, load_jax_params
from vdetr_tpu_torch.data.dataset_config import \
    ScannetDatasetConfig as PortScannetConfig
from vdetr_tpu_torch.data.synthetic import SyntheticDetectionDataset, collate
from vdetr_tpu_torch.main import make_args_parser
from vdetr_tpu_torch.models.mlp import GenericMLP
from vdetr_tpu_torch.models.position_embedding import \
    PositionEmbeddingCoordsSine
from vdetr_tpu_torch.models.transformer import ShareSelfAttention
from vdetr_tpu_torch.models.vdetr import build_model, random_fps_permutation
from vdetr_tpu_torch.train.criterion import SetCriterion
from vdetr_tpu_torch.train.engine import INPUT_KEYS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLAGS = dict(pos_for_key=True, share_selfattn=True, querypos_mlp=False,
             mlp_norm="ln", mlp_act="gelu")
# f32 through a few layers summed in other orders: ~1e-7 relative
MODULE_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _mlp_state(params, stats, norm):
    """A flax GenericMLP's (two hidden layers, no output norm) variables
    as the port's state_dict (`models/mlp.py`'s Sequential indices)."""
    sd, idx = {}, 0
    for h in range(2):
        sd[f"layers.{idx}.weight"] = _t(params[f"layer{h}"]["kernel"]).T[
            :, :, None]
        if norm in ("ln", "bn1d"):
            sd[f"layers.{idx + 1}.weight"] = _t(params[f"norm{h}"]["scale"])
            sd[f"layers.{idx + 1}.bias"] = _t(params[f"norm{h}"]["bias"])
        if norm == "bn1d":
            sd[f"layers.{idx + 1}.running_mean"] = _t(stats[f"norm{h}"]["mean"])
            sd[f"layers.{idx + 1}.running_var"] = _t(stats[f"norm{h}"]["var"])
        idx += 3 + (norm is not None)
    sd[f"layers.{idx}.weight"] = _t(params["out"]["kernel"]).T[:, :, None]
    sd[f"layers.{idx}.bias"] = _t(params["out"]["bias"])
    return sd


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu", "leakyrelu"])
@pytest.mark.parametrize("norm", [None, "id", "ln", "bn1d"])
def test_generic_mlp_norms_and_activations_match_jax(norm, act, train):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 6).astype(np.float32)
    jm = JaxMLP(hidden_dims=[16, 16], output_dim=5, norm=norm,
                activation=act, dropout=0.0)
    shapes = jax.eval_shape(lambda k: jm.init(k, x), jax.random.PRNGKey(0))
    params = _random_tree(shapes["params"], rng)
    stats = _random_tree(shapes.get("batch_stats", {}), rng, stats=True)
    want = jm.apply({"params": params, "batch_stats": stats}, x,
                    train=train, mutable=["batch_stats"])[0]
    port = GenericMLP(6, [16, 16], 5, dropout=0.0, norm=norm, activation=act)
    port.load_state_dict(_mlp_state(params, stats, norm), strict=True)
    port.train(train)
    got = port(torch.from_numpy(x), torch.Generator())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=MODULE_TOL, atol=MODULE_TOL)


@pytest.mark.parametrize("pos_type", ["fourier", "sine"])
def test_coordinate_embedding_matches_jax(pos_type):
    """Normalized by the scene's range first; the Fourier matrix is the
    JAX constant (RandomState(0)), carried as a buffer."""
    rng = np.random.RandomState(0)
    xyz = (rng.rand(2, 9, 3) * 4 - 1).astype(np.float32)
    lo, hi = xyz.min(1), xyz.max(1)
    jm = JaxPosSine(d_pos=32, pos_type=pos_type)
    for nc in (None, 20):
        want, variables = jm.init_with_output(
            jax.random.PRNGKey(0), xyz, input_range=[lo, hi],
            num_channels=nc)
        port = PositionEmbeddingCoordsSine(d_pos=32, pos_type=pos_type)
        if pos_type == "fourier":
            np.testing.assert_array_equal(
                port.gauss_B.numpy(),
                np.asarray(variables["constants"]["gauss_B"]))
        got = port(torch.from_numpy(xyz), [_t(lo), _t(hi)], num_channels=nc)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=MODULE_TOL, atol=MODULE_TOL)


def test_share_self_attention_matches_jax():
    """One K/V head of width dim / heads under every query head."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 11, 32).astype(np.float32) for _ in range(3))
    jm = JaxShareSelfAttention(dim=32, num_heads=4)
    shapes = jax.eval_shape(lambda key: jm.init(key, q, k, v),
                            jax.random.PRNGKey(0))
    params = _random_tree(shapes["params"], rng)
    want = jm.apply({"params": params}, q, k, v)
    port = ShareSelfAttention(32, 4)
    port.load_state_dict({f"{n}.{t}": (_t(params[n]["kernel"]).T
                                       if t == "weight"
                                       else _t(params[n]["bias"]))
                          for n in ("q", "k", "v", "proj")
                          for t in ("weight", "bias")})
    got = port(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=MODULE_TOL, atol=MODULE_TOL)


def test_cli_takes_every_configuration_flag():
    args = make_args_parser().parse_args(
        ["--depth", "50", "--compute_dtype", "bfloat16", "--pos_for_key",
         "1", "--share_selfattn", "1", "--querypos_mlp", "0", "--mlp_norm",
         "ln", "--mlp_act", "gelu", "--random_fps", "1"])
    cfg = VDETRConfig(**{k: getattr(args, k) for k in (
        "depth", "compute_dtype", "pos_for_key", "share_selfattn",
        "querypos_mlp", "mlp_norm", "mlp_act", "random_fps")})
    assert (cfg.depth, cfg.compute_dtype, cfg.querypos_mlp) == \
        (50, "bfloat16", False)
    build_model(cfg.replace(**TINY), PortScannetConfig(), device="cpu")


def _grads_tree(model, cfg):
    """The port's gradients as a flax params tree; a parameter the loss
    does not reach (the discarded query projection) has gradient 0, as
    under jax.grad."""
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    return _flatten(jax_trees(grads, cfg)[0])


def jax_and_port_step(kw, seed=5):
    """(reference, port) of one train step of TINY + `kw` on two synthetic
    scenes, dropout 0, the JV matcher: loss, loss terms, the last layer's
    predictions and proposal centers, gradients (unclipped) and the batch
    norms' new running statistics, flax trees of numpy arrays."""
    jcfg, cfg = JaxConfig(**{**TINY, **kw}), VDETRConfig(**{**TINY, **kw})
    data = SyntheticDetectionDataset(PortScannetConfig(), num_points=1024,
                                     num_scenes=2, max_objects=4, seed=4)
    batch = collate([data[i] for i in range(2)])
    inputs = {k: jnp.asarray(batch[k]) for k in INPUT_KEYS}
    targets = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = build_jax_model(jcfg, ScannetDatasetConfig())
    shapes = flax_shapes(cfg, PortScannetConfig())
    rng = np.random.RandomState(seed)
    params = _random_tree(shapes["params"], rng)
    stats = _random_tree(shapes["batch_stats"], rng, stats=True)
    # querypos_mlp=False: the Fourier matrix, JAX's constant
    consts = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32),
                          shapes["constants"])
    crit = JaxCriterion(jcfg, ScannetDatasetConfig())

    def loss_fn(p):
        out, mutated = jm.apply(
            {"params": p, "batch_stats": stats, "constants": consts}, inputs,
            train=True, mutable=["batch_stats"])
        loss, parts = crit(out, targets)
        return loss, (parts, out["outputs"], mutated["batch_stats"])

    (loss, (parts, outs, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    keys = ("sem_cls_logits", "center_unnormalized", "size_unnormalized",
            "pre_box_center_unnormalized")
    ref = dict(loss=float(loss), parts=jax.tree.map(float, parts),
               outs={k: np.asarray(outs[k]) for k in keys},
               grads=_flatten(jax.tree.map(np.asarray, grads)),
               stats=_flatten(jax.tree.map(np.asarray, new_stats)))

    port = build_model(cfg, PortScannetConfig(), device="cpu")
    load_jax_params(port, params, stats, cfg, consts)
    assert bool(consts) == (not cfg.querypos_mlp)
    port.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = port({k: tb[k] for k in INPUT_KEYS}, generator=torch.Generator())
    p_loss, p_parts = SetCriterion(cfg, PortScannetConfig())(out, tb)
    p_loss.backward()
    got = dict(loss=float(p_loss.detach()),
               parts={k: float(v.detach()) for k, v in p_parts.items()},
               outs={k: out["outputs"][k].detach().numpy() for k in keys},
               grads=_grads_tree(port, cfg),
               stats=_flatten(jax_trees(port.state_dict(), cfg)[1]))
    return ref, got


def deep_jax_trees(depth):
    """The JAX model's params and batch_stats at `depth` (the trees of
    `jax.eval_shape` of its init), drawn from RandomState(0): a spawned
    process's work."""
    cfg = JaxConfig(**{**TINY, "depth": depth, "dec_nlayers": 2})
    jm = build_jax_model(cfg, ScannetDatasetConfig())
    shapes = jax.eval_shape(
        lambda k, i: jm.init(k, i, train=False), jax.random.PRNGKey(0),
        jax.tree.map(jnp.asarray, make_inputs()))
    rng = np.random.RandomState(0)
    return (_random_tree(shapes["params"], rng),
            _random_tree(shapes["batch_stats"], rng, stats=True))


@pytest.fixture(scope="module")
def steps_and_trees():
    """The depth-50 flags step here, and meanwhile JAX's trees at depths
    101 and 152 in a spawned process (tracing holds the interpreter
    lock): (step, {depth: (params, batch_stats)})."""
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=spawn) as procs:
        trees = {d: procs.submit(deep_jax_trees, d) for d in (101, 152)}
        step = jax_and_port_step(dict(depth=50, dec_nlayers=2, **FLAGS))
        return step, {d: f.result() for d, f in trees.items()}


@pytest.fixture(scope="module")
def flags_step(steps_and_trees):
    return steps_and_trees[0]


def test_flags_step_loss_and_terms_match_jax(flags_step):
    ref, got = flags_step
    assert got["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
    assert set(got["parts"]) == set(ref["parts"])
    for k, v in ref["parts"].items():
        assert got["parts"][k] == pytest.approx(v, rel=LOSS_RTOL, abs=1e-6), k


def test_flags_step_forward_matches_jax(flags_step):
    """The train-mode forward (batch statistics, dropout 0) through the
    Bottleneck backbone and every decoder and head flag."""
    ref, got = flags_step
    for k, want in ref["outs"].items():
        np.testing.assert_allclose(got["outs"][k], want, rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_flags_step_every_gradient_matches_jax(flags_step):
    ref, got = flags_step
    assert set(got["grads"]) == set(ref["grads"])
    top = max(np.abs(g).max() for g in ref["grads"].values())
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(
            got["grads"][k], want, rtol=0,
            atol=max(GRAD_TOL * np.abs(want).max(), GRAD_FLOOR * top),
            err_msg=str(k))
    # the Bottleneck's third conv and the flags' modules are all there
    assert any("conv3" in "/".join(k) for k in ref["grads"])
    assert any("key_pos_projection0" in k for k in ref["grads"])


def test_flags_step_running_stats_match_jax(flags_step):
    ref, got = flags_step
    assert set(got["stats"]) == set(ref["stats"])
    for k, want in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k], want, rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=str(k))


@pytest.mark.parametrize("depth", [101, 152])
def test_deep_bottleneck_trees_cross_the_bridge_both_ways(depth,
                                                          steps_and_trees):
    """Every leaf of the JAX model's params and batch_stats at this depth
    loads into the port (a strict load) and comes back equal."""
    params, stats = steps_and_trees[1][depth]
    pcfg = VDETRConfig(**{**TINY, "depth": depth, "dec_nlayers": 2})
    port = build_model(pcfg, PortScannetConfig(), device="cpu")
    load_jax_params(port, params, stats, pcfg)
    back_p, back_s, _ = jax_trees(port.state_dict(), pcfg)
    for want, got in ((params, back_p), (stats, back_s)):
        want, got = _flatten(want), _flatten(got)
        assert set(want) == set(got)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], np.asarray(v),
                                          err_msg=str(k))
    blocks = {k[1] for k in _flatten(params) if k[0] == "pre_encoder"}
    assert f"layer3_block{22 if depth == 101 else 35}" in blocks


def _fpn_output(model, inputs, generator=None):
    """The model's outputs and its FPN output grid (a forward hook)."""
    seen = {}
    hook = model.out_block_0.register_forward_hook(
        lambda m, a, out: seen.setdefault("grid", out))
    try:
        out = model(inputs, generator=generator)
    finally:
        hook.remove()
    return out, seen["grid"]


def test_random_fps_permutes_only_in_training():
    """Eval: bit-equal to random_fps=False. Train: FPS over the voxels in
    the order drawn from the generator (row 0 first) picks JAX's
    `furthest_point_sample` indices on the same permutation, and the
    seeds are those voxels."""
    kw = {**TINY, "mlp_dropout": 0.0, "dec_dropout": 0.0}
    cfg = VDETRConfig(**kw, random_fps=True)
    gen = torch.Generator().manual_seed(0)
    model = build_model(cfg, PortScannetConfig(), generator=gen,
                        device="cpu")
    plain = build_model(VDETRConfig(**kw), PortScannetConfig(),
                        device="cpu")
    plain.load_state_dict(model.state_dict())
    inputs = {k: torch.from_numpy(v) for k, v in make_inputs().items()}
    with torch.no_grad():
        a, b = model(inputs), plain(inputs)
        for k in ("sem_cls_logits", "box_corners"):
            assert torch.equal(a["outputs"][k], b["outputs"][k]), k
        assert torch.equal(a["seed_inds"], b["seed_inds"])

        model.train()
        out, grid = _fpn_output(model, inputs, torch.Generator().manual_seed(3))
    vox = (grid.world_xyz() * grid.valid[..., None]).numpy()
    perm = random_fps_permutation(*grid.valid.shape,
                                  torch.Generator().manual_seed(3)).numpy()
    permuted = np.take_along_axis(vox, perm[..., None], axis=1)
    want = np.asarray(jax_fps(jnp.asarray(permuted), cfg.preenc_npoints,
                              impl="jax"))
    np.testing.assert_array_equal(out["seed_inds"].numpy(), want)
    np.testing.assert_array_equal(
        out["seed_xyz"].numpy(),
        np.take_along_axis(permuted, want[..., None], axis=1))
    assert not np.array_equal(want, b["seed_inds"].numpy())
