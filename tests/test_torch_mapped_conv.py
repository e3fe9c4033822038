"""The port's mapped sparse-conv route against the JAX package.

The conv over a neighbour map (kernel H's plain version), its weight
gradient (kernel I's) and the autograd Function `_MappedConv`
(`vdetr_tpu_torch/ops/sparse_conv_kernel.py`), held to:
- `sparse_conv._gather_matmul` over the same map and its `jax.vjp`, f32;
- the TPU kernels `window_conv` / `window_conv_dw` in interpret mode over
  `build_window_map` of the same map, on inputs rounded to bf16 values so
  that the TPU kernels' bf16 casts are exact;
- `jax.vjp` of the JAX `sparse_conv` / `sparse_conv_down`, which on the
  CPU run the gather path over attached kernel maps: the mapped route.
Then the whole tiny model with `conv_route="mapped"` against the JAX
model on the same converted weights, and the route's map and conv counts
(kernel G 9, H 37 per forward; H 69, I 37 with the backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import (MODEL_ATOL, MODEL_RTOL, jax_and_port,
                              make_inputs, run_jax, run_port, tiny_config)
from tests.test_window_conv import _comb_wall_grid, _grid
from vdetr_tpu.ops import sparse_conv as jsc
from vdetr_tpu.ops import sparse_conv_kernel as jsk
from vdetr_tpu.ops.voxelize import downsample_grid as jax_downsample
from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
from vdetr_tpu_torch.models.vdetr import build_model
from vdetr_tpu_torch.ops import map_kernel as tmk
from vdetr_tpu_torch.ops import sparse_conv as tsc
from vdetr_tpu_torch.ops import sparse_conv_keyed as tkc
from vdetr_tpu_torch.ops import sparse_conv_kernel as tsk
from vdetr_tpu_torch.ops.voxelize import VoxelGrid

# f32 gather-matmul sums of <= 27 * C products (or, for dW, of ~500 rows)
# taken in another order than XLA's: 1e-5 of the largest entry
REL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def port_grid(jg):
    return VoxelGrid(coords=t(jg.coords), keys=t(jg.keys),
                     features=t(jg.features), valid=t(jg.valid),
                     origin=t(jg.origin), stride=jg.stride,
                     extent=tuple(jg.extent), voxel_size=jg.voxel_size)


def assert_close(got, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=REL * max(1.0, np.abs(ref).max()),
                               err_msg=what)


def conv_case(rng, cin, cout, stride, B=2):
    """A clustered scene (tests/test_window_conv.py) with features, the
    map of a submanifold or stride-2 conv on it, weights and a dout."""
    jg = _grid(rng, V=512, B=B)
    out = jax_downsample(jg, 256) if stride == 2 else jg
    q = out.coords * 2 if stride == 2 else out.coords
    nbr = tmk.neighbour_map(t(jg.keys), t(q), t(out.valid), jg.extent)
    f = (rng.randn(B, 512, cin) * np.asarray(jg.valid)[..., None]).astype(
        np.float32)
    w = (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    dout = (rng.randn(B, out.keys.shape[1], cout)
            * np.asarray(out.valid)[..., None]).astype(np.float32)
    return jg, out, nbr, f, w, dout


@pytest.mark.parametrize("cin,cout,stride", [(16, 24, 1), (3, 16, 2),
                                             (40, 8, 2)])
def test_plain_conv_and_dw_match_gather_matmul(rng, cin, cout, stride):
    """H's and I's plain versions against `_gather_matmul` over the same
    map and its vjp with respect to W."""
    _, _, nbr, f, w, dout = conv_case(rng, cin, cout, stride)
    ref, vjp = jax.vjp(
        lambda ww: jax.vmap(lambda ff, ii: jsc._gather_matmul(ff, ii, ww))(
            jnp.asarray(f), jnp.asarray(nbr.numpy())), jnp.asarray(w))
    (dw_ref,) = vjp(jnp.asarray(dout))
    assert_close(tsk.mapped_conv_plain(t(f), nbr, t(w)), ref, "out")
    assert_close(tsk.mapped_conv_dw_plain(t(f), nbr, t(dout)), dw_ref, "dW")


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("layout", ["clustered", "comb-wall"])
def test_plain_conv_matches_window_conv_interpret(rng, layout):
    """H's plain version against the TPU kernel over `build_window_map` of
    the same map, on the valid rows the TPU kernel's windows cover (its
    `bad` rows are patched outside the kernel); the comb wall has such
    rows."""
    jg = (_grid(rng, V=512) if layout == "clustered" else _comb_wall_grid())
    V = jg.keys.shape[1]
    nbr = tmk.neighbour_map(t(jg.keys), t(jg.coords), t(jg.valid), jg.extent)
    blk, le, bad = jsk.build_window_map(jnp.asarray(nbr[0].numpy()), V, 128,
                                        128)
    f = _bf16(rng.randn(1, V, 16) * np.asarray(jg.valid)[..., None])
    w = _bf16(rng.randn(27, 16, 8) / np.sqrt(27 * 16))
    ref = jsk.window_conv(jnp.asarray(f), blk[None], le[None], jnp.asarray(w),
                          tile=128, wb=128, interpret=True)
    rows = np.asarray(jg.valid)[0] & ~np.asarray(bad)
    assert (layout == "comb-wall") == bool(np.asarray(bad).any())
    got = tsk.mapped_conv_plain(t(f), nbr, t(w))
    assert_close(got[0].numpy()[rows], np.asarray(ref)[0][rows])


def test_plain_dw_matches_window_conv_dw_interpret(rng):
    """I's plain version against the TPU kernel, on a layout its windows
    cover entirely (no `bad` row)."""
    jg = _grid(rng, V=512)
    nbr = tmk.neighbour_map(t(jg.keys), t(jg.coords), t(jg.valid), jg.extent)
    blk, le, bad = jsk.build_window_map(jnp.asarray(nbr[0].numpy()), 512, 128,
                                        128)
    assert not bool(np.asarray(bad).any())
    valid = np.asarray(jg.valid)[..., None]
    f = _bf16(rng.randn(1, 512, 16) * valid)
    dout = _bf16(rng.randn(1, 512, 8) * valid)
    ref = jsk.window_conv_dw(jnp.asarray(f), blk[None], le[None],
                             jnp.asarray(dout), tile=128, wb=128,
                             interpret=True)
    assert_close(tsk.mapped_conv_dw_plain(t(f), nbr, t(dout)), ref)


@pytest.mark.parametrize("stride", [1, 2], ids=["submanifold", "stride-2"])
def test_mapped_conv_gradients_match_jax_sparse_conv(rng, stride):
    """Output, dFeats (the flipped-weight conv over the same map, or the
    transpose scatter over the saved map) and dW of the port's
    `sparse_conv` / `sparse_conv_down` on the mapped route against
    `jax.vjp` of the JAX functions."""
    jg, jout, _, f, w, dout = conv_case(rng, 12, 20, stride)
    tg, tout = port_grid(jg), port_grid(jout)

    def jax_fn(ff, ww):
        g = jg.replace(features=ff)
        if stride == 1:
            return jsc.sparse_conv(jsc.attach_kernel_map(g), ww).features
        return jsc.sparse_conv_down(g, ww, out_grid=jout).features

    ref, vjp = jax.vjp(jax_fn, jnp.asarray(f), jnp.asarray(w))
    df_ref, dw_ref = vjp(jnp.asarray(dout))

    f_t, w_t = t(f).requires_grad_(), t(w).requires_grad_()
    g = tg.replace(features=f_t)
    if stride == 1:
        g = tsc.attach_kernel_map(g)
        out = tsc.sparse_conv(g, w_t).features
    else:
        out = tsc.sparse_conv_down(g, w_t, out_grid=tout,
                                   route="mapped").features
    df, dw = torch.autograd.grad(out, (f_t, w_t), t(dout))
    for what, got, r in (("out", out.detach(), ref), ("dFeats", df, df_ref),
                         ("dW", dw, dw_ref)):
        assert_close(got.numpy(), r, what)


@pytest.fixture(scope="module")
def mapped_models():
    cfg = tiny_config()
    return (cfg,) + jax_and_port(cfg, conv_route="mapped")


def test_mapped_model_forward_matches_jax(mapped_models):
    """The whole tiny model on the mapped route against the JAX model on
    the same weights: every decoder layer's outputs, the encoder box
    predictions and the seeds (the tolerance of tests/test_torch_model.py)."""
    cfg, jm, variables, port = mapped_models
    inputs = make_inputs(seed=2)
    ref = run_jax(jm, variables, inputs)
    got = run_port(port, inputs)
    np.testing.assert_array_equal(got["seed_inds"], ref["seed_inds"])
    for part in ("enc_outputs", "outputs"):
        for k, v in ref[part].items():
            np.testing.assert_allclose(got[part][k], v, atol=MODEL_ATOL,
                                       rtol=MODEL_RTOL, err_msg=f"{part} {k}")
    for a, b in zip(ref["aux_outputs"], got["aux_outputs"]):
        for k, v in a.items():
            np.testing.assert_allclose(b[k], v, atol=MODEL_ATOL,
                                       rtol=MODEL_RTOL, err_msg=f"aux {k}")


def test_mapped_route_counts_and_equals_keyed_route(mapped_models,
                                                    monkeypatch):
    """Per forward the mapped route builds 9 maps (5 stride-2, 4 levels)
    in 5 launches of kernel G (the stem's stride-2 map alone, each stage's
    stride-2 map and level map together) and runs 37 mapped convs and no
    keyed conv; with a backward from the FPN output, 69 mapped convs (37 +
    32 submanifold dFeats) and 37 weight gradients, no map rebuilt. On the
    CPU both routes take the same plain ops, so their outputs are equal."""
    cfg, _, _, mapped = mapped_models
    calls = {"map": 0, "pair": 0, "conv": 0, "dw": 0, "keyed": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(tsc, "kernel_map", counted("map", tmk.kernel_map))
    monkeypatch.setattr(tsc, "kernel_map_pair",
                        counted("pair", tmk.kernel_map_pair))
    monkeypatch.setattr(tsk, "mapped_conv", counted("conv", tsk.mapped_conv))
    monkeypatch.setattr(tsk, "mapped_conv_dw",
                        counted("dw", tsk.mapped_conv_dw))
    monkeypatch.setattr(tkc, "keyed_conv", counted("keyed", tkc.keyed_conv))
    inputs = {k: t(v) for k, v in make_inputs(seed=3).items()}
    keyed = build_model(cfg, ScannetDatasetConfig(), device="cpu")
    keyed.load_state_dict(mapped.state_dict())
    with torch.no_grad():
        ref = keyed(inputs, debug_stop=3)["digest"]
        calls.update(map=0, pair=0, conv=0, dw=0, keyed=0)
        got = mapped(inputs, debug_stop=3)["digest"]
    assert calls == {"map": 1, "pair": 4, "conv": 37, "dw": 0, "keyed": 0}
    assert float(got) == float(ref)
    calls.update(map=0, pair=0, conv=0, dw=0, keyed=0)
    mapped.train()
    try:
        mapped(inputs, debug_stop=3)["digest"].backward()
    finally:
        mapped.eval()
        mapped.zero_grad(set_to_none=True)
    assert calls == {"map": 1, "pair": 4, "conv": 69, "dw": 37, "keyed": 0}


def test_build_model_refuses_unknown_route():
    with pytest.raises(ValueError):
        build_model(tiny_config(), ScannetDatasetConfig(), device="cpu",
                    conv_route="hashed")


def test_every_kernel_source_declares_its_c_signature():
    """Each registered kernel builds from `csrc/<name>.cu`, which declares
    its C entry with as many parameters as the ctypes signature has: a
    mismatch would pass pointers into the wrong slots on the card."""
    import re

    from vdetr_tpu_torch import kernels

    assert {"map_kernel", "mapped_conv", "mapped_conv_dw", "rpe_ablate",
            "dot_micro", "rpe_table_sum"} <= set(kernels._SIGNATURES)
    for name, (fn_name, argtypes) in kernels._SIGNATURES.items():
        src = (kernels._CSRC / f"{name}.cu").read_text()
        decl = re.search(r'extern "C" int ' + fn_name + r"\(([^)]*)\)", src)
        assert decl is not None, (name, fn_name)
        assert len(decl.group(1).split(",")) == len(argtypes), name
