"""`compute_dtype="bfloat16"` in the port against the JAX package's bf16
path on the CPU (the port's bf16 kernels' plain versions: bf16 operands
multiplied as the float32 numbers they are, float32 sums).

- The sparse conv's dtypes, forward and backward, against `jax.vjp` of
  `sparse_conv._gather_matmul` at bf16, both routes, submanifold and
  stride 2: a float32 output; dFeats rounded to bf16 (JAX rounds each
  offset's product and sums them in bf16, the port rounds the float32
  sum once); dW the float32 sum rounded to bf16, as float32.
- The bf16 backbone at `tests/test_bf16_numerics.py`'s grid (depth 18,
  inplanes 16): every stage within 1% of its largest value of JAX's bf16
  backbone (a bf16 ulp is 0.39%).
- The bf16 model's logits: cosine > 0.9999 against JAX's bf16 model (the
  train step's forward); and, in eval mode, against JAX's float32 model
  JAX's own bounds (`tests/test_model.py`): cosine > 0.999, median
  center deviation < 0.02.
- The bf16 train step's gradients against JAX's bf16 step: relative L2
  <= 1e-2 per tensor.

The model-level comparisons take a configuration whose outputs are
continuous in the backbone's features (`WELL_POSED`): every seed a
proposal (nqueries = preenc_npoints) with its own features as the query
(q_content "sample"), and unit anchors (hard_anchor). At random weights
the published choices are discontinuous there: the seeds' objectness
lies ~1e-3 apart near the top-k cut and in its order, the anchor size is
the argmax of 18 class scores, and bf16 moves both by ~4e-3 (JAX's bf16
model against its own float32 model as much as the port's against
JAX's), so two bf16 computations pick other proposals, slots (under
q_content "random" one learned query each) and anchors, and every
decoder output and gradient differs. At `WELL_POSED` the decoder is
equivariant to the order of its queries and the loss invariant to it:
the outputs are compared query by query, matched by their proposal's
center, and the gradients as they are. JAX's decoder runs its RPE bias
in float32 here, as its fused TPU path (the published `rpe_impl`) does
whatever `compute_dtype` says, and as the port does; off the TPU its
materialized path would round the tables and the interpolation weights
to bf16 (`jax_rpe_in_f32`).
"""

import contextlib
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_configs import jax_and_port_step
from test_torch_model import _random_tree, flax_shapes, make_inputs
from test_torch_train_step import TINY
from vdetr_tpu.config import VDETRConfig as JaxConfig
from vdetr_tpu.data import ScannetDatasetConfig
from vdetr_tpu.models import build_model as build_jax_model
from vdetr_tpu.models.backbone import SparseResNet as JaxResNet
from vdetr_tpu.ops.sparse_conv import _gather_matmul
from vdetr_tpu.ops.voxelize import voxelize as jax_voxelize
from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.convert import (build_reference_state_dict,
                                     from_reference_state_dict, jax_trees,
                                     load_jax_params)
from vdetr_tpu_torch.data.dataset_config import \
    ScannetDatasetConfig as PortScannetConfig
from vdetr_tpu_torch.models.backbone import SparseResNet
from vdetr_tpu_torch.models.vdetr import build_model
from vdetr_tpu_torch.ops.map_kernel import neighbour_map
from vdetr_tpu_torch.ops.sparse_conv_keyed import keyed_conv_ad
from vdetr_tpu_torch.ops.sparse_conv_kernel import mapped_conv_ad
from vdetr_tpu_torch.ops.voxelize import downsample_grid, voxelize
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BF16 = dict(compute_dtype="bfloat16")
WELL_POSED = dict(nqueries=TINY["preenc_npoints"], q_content="sample",
                  hard_anchor=True)
# a gradient through bf16 storage: each backbone conv's dFeats rounded
# to bf16 (2^-9), once by the port, per offset by JAX
GRAD_REL_L2 = 1e-2


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


@pytest.mark.parametrize("submanifold", [True, False])
@pytest.mark.parametrize("route", ["keyed", "mapped"])
def test_bf16_conv_dtypes_match_jax_vjp(route, submanifold):
    rng = np.random.RandomState(0)
    pts = rng.rand(1, 600, 3).astype(np.float32) * [1.0, 1.0, 0.5]
    feats = rng.randn(1, 600, 16).astype(np.float32)
    fine = voxelize(torch.from_numpy(pts), torch.from_numpy(feats),
                    torch.ones(1, 600, dtype=torch.bool), voxel_size=0.05,
                    capacity=512, extent=(64, 64, 32))
    out = fine if submanifold else downsample_grid(fine, 256)
    q = out.coords if submanifold else out.coords * 2
    nbr = neighbour_map(fine.keys, q, out.valid, fine.extent)
    x = fine.features.to(torch.bfloat16)
    w = torch.from_numpy(rng.randn(27, 16, 24).astype(np.float32) * 0.1)
    dout = torch.from_numpy(rng.randn(*out.valid.shape, 24).astype(
        np.float32)) * out.valid[..., None]

    xp = x.clone().requires_grad_()
    wp = w.clone().requires_grad_()
    w16 = wp.to(torch.bfloat16)
    if route == "keyed":
        y = keyed_conv_ad(xp, fine.keys, q, out.valid, fine.extent, w16,
                          submanifold=submanifold)
    else:
        y = mapped_conv_ad(xp, nbr, w16, submanifold=submanifold)
    y.backward(dout)
    assert y.dtype == torch.float32
    assert xp.grad.dtype == torch.bfloat16 and wp.grad.dtype == torch.float32

    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)[0]
    want, vjp = jax.vjp(lambda f, k: _gather_matmul(f, jnp.asarray(
        nbr[0].numpy()), k, jnp.bfloat16), jx, jnp.asarray(w.numpy()))
    dx, dw = vjp(jnp.asarray(dout[0].numpy()))
    assert dx.dtype == jnp.bfloat16 and dw.dtype == jnp.float32
    np.testing.assert_allclose(y[0].detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # dW: one rounding of the same float32 sum (up to its order): at
    # most one bf16 ulp apart
    dw_p, dw_j = wp.grad.numpy(), np.asarray(dw)
    assert np.array_equal(dw_p, np.asarray(jnp.asarray(
        dw_p, jnp.bfloat16).astype(jnp.float32)))  # bf16 values
    np.testing.assert_allclose(dw_p, dw_j, rtol=2 ** -7, atol=1e-6)
    assert rel_l2(xp.grad[0].float().numpy(),
                  np.asarray(dx.astype(jnp.float32))) <= 5e-3


def _grid_inputs():
    rng = np.random.RandomState(0)  # test_bf16_numerics' `rng` fixture
    N = 3000
    pts = rng.rand(2, N, 3).astype(np.float32) * np.array([3.0, 3.0, 2.0])
    feats = rng.rand(2, N, 3).astype(np.float32)
    return pts, feats


def test_bf16_backbone_stages_match_jax_bf16():
    pts, feats = _grid_inputs()
    caps = (1024, 512, 256, 128, 128)
    kw = dict(voxel_size=0.05, capacity=2048, extent=(128, 128, 64))
    jgrid = jax_voxelize(jnp.asarray(pts), jnp.asarray(feats),
                         jnp.ones((2, pts.shape[1]), bool), **kw)
    jm = JaxResNet(depth=18, inplanes=16, stage_capacities=caps,
                   compute_dtype=jnp.bfloat16)
    cfg = VDETRConfig(depth=18, inplanes=16)
    port = SparseResNet(3, depth=18, inplanes=16, stage_capacities=caps,
                        compute_dtype=torch.bfloat16)
    # the flax trees' paths and shapes off the port's backbone, the model's
    # "pre_encoder" (test_torch_model.flax_shapes)
    shapes = [t["pre_encoder"] for t in jax_trees(
        {"pre_encoder." + k: v for k, v in port.state_dict().items()},
        cfg)[:2]]
    rng = np.random.RandomState(1)
    params = _random_tree(shapes[0], rng)
    stats = _random_tree(shapes[1], rng, stats=True)
    want = jax.jit(lambda v, g: jm.apply(v, g, train=False))(
        {"params": params, "batch_stats": stats}, jgrid)

    sd = from_reference_state_dict(build_reference_state_dict(
        {"pre_encoder": params}, {"pre_encoder": stats}, cfg))
    port.load_state_dict({k[len("pre_encoder."):]: v for k, v in sd.items()},
                         strict=True)
    port.eval()
    grid = voxelize(torch.from_numpy(pts), torch.from_numpy(feats),
                    torch.ones(2, pts.shape[1], dtype=torch.bool), **kw)
    with torch.no_grad():
        got = port(grid)
    for s, (a, b) in enumerate(zip(want, got)):
        assert b.features.dtype == torch.bfloat16
        fa = np.asarray(a.features.astype(jnp.float32))
        fb = b.features.float().numpy()
        dev = np.abs(fa - fb).max() / np.abs(fa).max()
        assert dev <= 0.01, f"stage {s}: {dev}"


@contextlib.contextmanager
def jax_rpe_in_f32():
    """JAX's materialized RPE bias without the bf16 rounding of its tables
    and interpolation weights: what its fused TPU path and the port
    compute under compute_dtype="bfloat16"."""
    import vdetr_tpu.models.transformer as jax_transformer

    sample = jax_transformer.trilinear_sample_matmul
    jax_transformer.trilinear_sample_matmul = \
        lambda *a, compute_dtype=None, **kw: sample(*a, **kw)
    try:
        yield
    finally:
        jax_transformer.trilinear_sample_matmul = sample


def _align(ref, got):
    """`got`'s outputs reordered to `ref`'s queries: each query matched to
    the one whose proposal center is nearest (seeds that FPS repeats are
    one query twice, with the same outputs)."""
    order = []
    for r, g in zip(ref["pre_box_center_unnormalized"],
                    got["pre_box_center_unnormalized"]):
        d = np.abs(r[:, None, :] - g[None, :, :]).max(-1)
        assert d.min(1).max() < 1e-2
        order.append(d.argmin(1))
    order = np.stack(order)
    return {k: np.take_along_axis(
        v, order.reshape(order.shape + (1,) * (v.ndim - 2)), axis=1)
        for k, v in got.items()}


def jax_f32_eval(variables, inputs):
    """JAX's float32 eval forward of the tiny model (a spawned process's
    work): the last layer's outputs."""
    jm = build_jax_model(JaxConfig(**{**TINY, **WELL_POSED}),
                         ScannetDatasetConfig())
    return jax.tree.map(np.asarray, jax.jit(
        lambda v, i: jm.apply(v, i, train=False)["outputs"])(
            variables, jax.tree.map(jnp.asarray, inputs)))


@pytest.fixture(scope="module")
def jax_sides():
    """JAX's float32 eval forward (weights of seed 1) in a spawned process
    while the bf16 train step of JAX and the port (`jax_and_port_step`)
    runs here: (eval outputs, eval weights, step)."""
    shapes = flax_shapes(VDETRConfig(**{**TINY, **WELL_POSED}),
                         PortScannetConfig())
    rng = np.random.RandomState(1)
    variables = {"params": _random_tree(shapes["params"], rng),
                 "batch_stats": _random_tree(shapes["batch_stats"], rng,
                                             stats=True)}
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=spawn) as procs:
        ref = procs.submit(jax_f32_eval, variables, make_inputs())
        with jax_rpe_in_f32():
            step = jax_and_port_step({**BF16, **WELL_POSED})
        return ref.result(), variables, step


@pytest.fixture(scope="module")
def eval_outputs(jax_sides):
    """The eval forward of the tiny model on the same weights: the port in
    bf16, JAX in float32, the port's queries aligned to JAX's."""
    ref, variables, _ = jax_sides
    inputs = make_inputs()
    cfg = VDETRConfig(**{**TINY, **BF16, **WELL_POSED})
    port = build_model(cfg, PortScannetConfig(), device="cpu")
    load_jax_params(port, variables["params"], variables["batch_stats"], cfg)
    with torch.no_grad():
        out = port({k: torch.from_numpy(v) for k, v in inputs.items()})
    return ref, _align(ref, {k: v.numpy() for k, v in out["outputs"].items()})


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_bf16_logits_track_jax_f32_within_its_own_bounds(eval_outputs):
    ref, got = eval_outputs
    assert got["sem_cls_logits"].dtype == np.float32
    cos = _cosine(got["sem_cls_logits"], ref["sem_cls_logits"])
    assert cos > 0.999, cos
    dev = np.median(np.abs(got["center_unnormalized"]
                           - ref["center_unnormalized"]))
    assert dev < 0.02, dev


@pytest.fixture(scope="module")
def bf16_step(jax_sides):
    return jax_sides[2]


def test_bf16_step_loss_matches_jax_bf16(bf16_step):
    ref, got = bf16_step
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-3)


def test_bf16_logits_match_jax_bf16(bf16_step):
    """The step's (train-mode) forward, query by query."""
    ref, got = bf16_step
    got = _align(ref["outs"], got["outs"])
    cos = _cosine(got["sem_cls_logits"], ref["outs"]["sem_cls_logits"])
    assert cos > 0.9999, cos


def test_bf16_step_gradients_match_jax_bf16(bf16_step):
    """Every gradient as one vector within 1e-2 relative L2 of JAX's, and
    the median tensor within 1e-3. The largest tensor errors (~2.5%) are
    the scales of the backbone's batch norms, whose train-mode statistics
    over a few hundred voxels of bf16 inputs amplify one-ulp differences
    of the stored features."""
    ref, got = bf16_step
    assert set(got["grads"]) == set(ref["grads"])
    keys = sorted(ref["grads"])
    want = np.concatenate([ref["grads"][k].ravel() for k in keys])
    have = np.concatenate([got["grads"][k].ravel() for k in keys])
    assert rel_l2(have, want) <= GRAD_REL_L2, rel_l2(have, want)
    top = max(np.linalg.norm(g) for g in ref["grads"].values())
    per = [rel_l2(got["grads"][k], w) for k, w in ref["grads"].items()
           if np.linalg.norm(w) > 1e-6 * top]
    assert np.median(per) <= 1e-3, np.median(per)


def test_bf16_entries_are_declared_in_their_sources():
    """Each bf16 form is a second C entry of its f32 form's source, with
    the f32 entry's arguments."""
    import re

    from vdetr_tpu_torch import kernels

    assert set(kernels._EXTRA) == {"keyed_conv_bf16", "keyed_conv_dw_bf16",
                                   "mapped_conv_bf16", "mapped_conv_dw_bf16"}
    for name, (source, fn_name, argtypes) in kernels._EXTRA.items():
        src = (kernels._CSRC / f"{source}.cu").read_text()
        decl = re.search(r'extern "C" int ' + fn_name + r"\(([^)]*)\)", src)
        assert decl is not None, name
        assert len(decl.group(1).split(",")) == len(argtypes), name
        assert argtypes == kernels._SIGNATURES[source][1]
