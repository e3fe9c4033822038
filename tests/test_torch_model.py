"""The PyTorch port's whole VDETR eval forward against the JAX package.

One tiny configuration (tests/test_model.py's) with random weights from
a numpy seed, so every head and norm statistic matters, carried from the
flax tree into the port through the weight bridge
(vdetr_tpu_torch/convert.py). Both run on
the CPU: JAX through its XLA paths (gather sparse convs, fps_jax, the
materialized RPE bias), the port through its kernels' plain versions.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetr_tpu.config import VDETRConfig
from vdetr_tpu.data import ScannetDatasetConfig
from vdetr_tpu.models import build_model as build_jax_model
from vdetr_tpu.train.torch_import import (_flatten,
                                          build_reference_state_dict,
                                          convert_torch_state_dict)
from vdetr_tpu_torch.convert import (from_reference_state_dict,
                                     load_jax_params, reference_state_dict)
from vdetr_tpu_torch.data.dataset_config import \
    ScannetDatasetConfig as PortScannetConfig
from vdetr_tpu_torch.models.vdetr import build_model as build_port_model

REPO = Path(__file__).resolve().parents[1]

# f32 through ~40 layers, summed in other orders by XLA and by torch:
# per-op differences are ~1e-7 relative; 1e-4 absolute on O(1..10)
# outputs leaves an order of magnitude of margin.
MODEL_ATOL = 1e-4
MODEL_RTOL = 1e-4


def tiny_config(**kw):
    base = dict(
        voxel_capacity=2048, min_stage_capacity=128,
        grid_extent=(128, 128, 64), preenc_npoints=128, nqueries=64,
        dec_nlayers=3, dec_dim=32, dec_ffn_dim=32, dec_nhead=4, rpe_dim=16,
        inplanes=8, enc_dim=32, fps_impl="jax", num_points=512,
    )
    base.update(kw)
    return VDETRConfig(**base)


def make_inputs(seed=0, B=2, N=512, n_valid=None):
    """Points in a 1.2 x 1.2 x 0.6 m box; with n_valid, only the first
    n_valid points of each row are valid (the rest are zero padding)."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(B, N, 3) * [1.2, 1.2, 0.6]).astype(np.float32)
    valid = np.ones((B, N), bool)
    if n_valid is not None:
        pts[:, n_valid:] = 0.0
        valid[:, n_valid:] = False
    real = pts[:, :n_valid] if n_valid is not None else pts
    return {"point_clouds": pts, "point_validity": valid,
            "point_cloud_dims_min": real.min(1),
            "point_cloud_dims_max": real.max(1)}


def _random_tree(tree, rng, stats=False):
    """Random values for every leaf of a flax variable tree (shapes from
    `tree`): kernels N(0, 1/fan_in), norm scales near 1, biases near 0,
    the query embedding N(0, 1); running means near 0 and variances in
    [0.5, 1.5]. Zero-initialised heads and unit norms are exercised too."""
    def one(path, x):
        name, shape = path[-1].key, x.shape
        if stats:
            if name == "var":
                return rng.uniform(0.5, 1.5, shape).astype(np.float32)
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "query_embed":
            return rng.randn(*shape).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


def jax_and_port(cfg):
    """(jax model, its variables as numpy, the port model with the same
    weights through the bridge). The flax tree's structure comes from
    `jax.eval_shape` (no compile); its values from a numpy seed."""
    jm = build_jax_model(cfg, ScannetDatasetConfig())
    inp = jax.tree.map(jnp.asarray, make_inputs())
    shapes = jax.eval_shape(lambda k, i: jm.init(k, i, train=False),
                            jax.random.PRNGKey(0), inp)
    rng = np.random.RandomState(1)
    params = _random_tree(shapes["params"], rng)
    stats = _random_tree(shapes["batch_stats"], rng, stats=True)
    port = build_port_model(cfg, PortScannetConfig())
    load_jax_params(port, params, stats, cfg)
    return jm, {"params": params, "batch_stats": stats}, port


_JITTED = {}


def run_jax(jm, variables, inputs, debug_stop=0):
    key = (id(jm), debug_stop)
    if key not in _JITTED:  # one compile per model and stage
        _JITTED[key] = jax.jit(lambda v, i: jm.apply(
            v, i, train=False, debug_stop=debug_stop))
    f = _JITTED[key]
    return jax.tree.map(np.asarray, f(variables, jax.tree.map(jnp.asarray,
                                                              inputs)))


def run_port(port, inputs, debug_stop=0):
    with torch.inference_mode():
        out = port({k: torch.from_numpy(v) for k, v in inputs.items()},
                   debug_stop=debug_stop)
    return _to_numpy(out)


def _to_numpy(x):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_numpy(v) for v in x]
    return x.numpy()


@pytest.fixture(scope="module")
def models():
    cfg = tiny_config()
    jm, variables, port = jax_and_port(cfg)
    return cfg, jm, variables, port


def _assert_preds_close(a, b, what):
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=MODEL_ATOL,
                                   rtol=MODEL_RTOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("n_valid", [None, 16], ids=["dense", "16-points"])
def test_forward_matches_jax(models, n_valid):
    """All outputs of every decoder layer, the encoder box predictions and
    the seeds. Seed indices are equal; with 16 valid points FPS repeats
    seeds and the padded ones must stay masked in both."""
    cfg, jm, variables, port = models
    inputs = make_inputs(seed=2, n_valid=n_valid)
    ref = run_jax(jm, variables, inputs)
    got = run_port(port, inputs)
    np.testing.assert_array_equal(got["seed_inds"], ref["seed_inds"])
    np.testing.assert_allclose(got["seed_xyz"], ref["seed_xyz"], atol=0)
    _assert_preds_close(ref["enc_outputs"], got["enc_outputs"], "enc")
    _assert_preds_close(ref["outputs"], got["outputs"], "final")
    assert len(got["aux_outputs"]) == len(ref["aux_outputs"]) == 2
    for i, (a, b) in enumerate(zip(ref["aux_outputs"], got["aux_outputs"])):
        _assert_preds_close(a, b, f"aux{i}")
    for k, v in got["outputs"].items():
        assert np.isfinite(v).all(), k


def test_topk_order_matches_lax_top_k():
    """Proposal selection: a stable descending sort picks the indices
    lax.top_k picks, lower index first among equal scores."""
    rng = np.random.RandomState(0)
    obj = rng.randint(0, 5, size=(3, 200)).astype(np.float32) / 4
    obj[1, 50:] = -np.inf
    _, ref = jax.lax.top_k(jnp.asarray(obj), 64)
    got = torch.sort(torch.from_numpy(obj), dim=1, descending=True,
                     stable=True).indices[:, :64]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_weight_bridge_round_trip(models):
    """JAX params -> port -> reference layout -> JAX params, exactly,
    with the kernel offset permutation applied and undone."""
    cfg, jm, variables, port = models
    sd = reference_state_dict(port)
    params, stats, report = convert_torch_state_dict(sd, cfg)
    assert not report["missing"] and not report["unused"], report
    for name, tree in (("params", params), ("batch_stats", stats)):
        want, got = _flatten(variables[name]), _flatten(tree)
        assert set(want) == set(got), set(want) ^ set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    # the port keeps the JAX package's z-fastest offsets: its stem kernel
    # equals the flax kernel, while the reference layout is permuted
    stem = port.state_dict()["pre_encoder.conv1.kernel"].numpy()
    np.testing.assert_array_equal(
        stem, variables["params"]["pre_encoder"]["conv1"]["kernel"])
    ref_sd = build_reference_state_dict(variables["params"],
                                        variables["batch_stats"], cfg)
    assert not np.array_equal(ref_sd["pre_encoder.conv1.kernel"], stem)
    assert set(from_reference_state_dict(ref_sd)) == set(port.state_dict())


def test_import_is_jax_free():
    code = ("import sys, vdetr_tpu_torch.models.vdetr, vdetr_tpu_torch.convert,"
            " vdetr_tpu_torch.data.synthetic, vdetr_tpu_torch.kernels;"
            " bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'flax')];"
            " print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """Without CUDA (and, alone in a directory, without the package) the
    smoke test exits non-zero and prints no result."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("option", [
    dict(depth=50), dict(querypos_mlp=False), dict(pos_for_key=True),
    dict(share_selfattn=True), dict(compute_dtype="bfloat16"),
    dict(mlp_act="gelu"), dict(random_fps=True)])
def test_build_model_refuses_unported_options(option):
    """Options the JAX model has and this slice does not port fail loudly
    instead of running something else."""
    with pytest.raises(NotImplementedError):
        build_port_model(tiny_config(**option), PortScannetConfig())
