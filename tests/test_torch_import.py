"""Torch checkpoint shim round-trip tests.

Without the real scannet_540ep.pth on disk we validate the mapping by
(1) exporting a randomly-initialized model to the reference state-dict
layout and importing it back (exact round trip), and (2) checking that
the mapping covers every parameter leaf of the model (nothing silently
dropped in either direction).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vdetr_tpu.config import VDETRConfig
from vdetr_tpu.data import ScannetDatasetConfig
from vdetr_tpu.models import build_model
from vdetr_tpu.train.torch_import import (
    build_reference_state_dict,
    convert_torch_state_dict,
    _flatten,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def model_vars():
    cfg = VDETRConfig(
        voxel_capacity=1024, min_stage_capacity=64,
        grid_extent=(64, 64, 32), preenc_npoints=64, nqueries=16,
        dec_nlayers=3, dec_dim=32, dec_ffn_dim=32, rpe_dim=16, inplanes=8,
        enc_dim=32, fps_impl="jax", num_points=256,
    )
    ds = ScannetDatasetConfig()
    model = build_model(cfg, ds)
    rng = np.random.RandomState(0)
    pts = rng.rand(1, 256, 3).astype(np.float32)
    inputs = {
        "point_clouds": jnp.asarray(pts),
        "point_cloud_dims_min": jnp.asarray(pts.min(1)),
        "point_cloud_dims_max": jnp.asarray(pts.max(1)),
    }
    variables = model.init(jax.random.PRNGKey(0), inputs, train=False)
    return cfg, variables


def test_roundtrip_exact(model_vars):
    cfg, variables = model_vars
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    sd = build_reference_state_dict(params, stats, cfg)
    assert len(sd) > 100
    p2, s2, report = convert_torch_state_dict(sd, cfg)
    assert not report["missing"], report["missing"][:10]
    assert not report["unused"], report["unused"][:10]
    flat_a, flat_b = _flatten(params), _flatten(p2)
    assert set(flat_a) == set(flat_b), (
        sorted(set(flat_a) ^ set(flat_b))[:10]
    )
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=str(k))
    sflat_a, sflat_b = _flatten(stats), _flatten(s2)
    assert set(sflat_a) == set(sflat_b), (
        sorted(set(sflat_a) ^ set(sflat_b))[:10]
    )
    for k in sflat_a:
        np.testing.assert_array_equal(sflat_a[k], sflat_b[k], err_msg=str(k))


def test_reference_names_look_right(model_vars):
    cfg, variables = model_vars
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    sd = build_reference_state_dict(params, stats, cfg)
    # spot-check names against the reference state-dict vocabulary
    assert "pre_encoder.conv1.kernel" in sd
    assert "pre_encoder.layer1.0.downsample.0.kernel" in sd
    assert "up_block_3.0.kernel" in sd
    assert "out_block_0.0.kernel" in sd
    assert "decoder.layers.0.self_attn.in_proj_weight" in sd
    assert "decoder.layers.0.multihead_attn.cpb_mlps.7.2.weight" in sd
    assert "decoder.mlp_heads.0.sem_cls_head.layers.8.weight" in sd
    assert "decoder.mlp_heads.2.center_head.layers.8.bias" in sd
    assert "decoder.query_embed.weight" in sd
    assert "encoder_to_decoder_projection.layers.1.running_mean" in sd
    # torch linear layout: (out, in)
    w = sd["decoder.layers.0.linear1.weight"]
    assert w.shape == (cfg.dec_ffn_dim, cfg.dec_dim)
    # packed qkv: (3*dim, dim)
    assert sd["decoder.layers.0.self_attn.in_proj_weight"].shape == (
        3 * cfg.dec_dim, cfg.dec_dim
    )
    # ME kernel: (27, in, out)
    assert sd["pre_encoder.layer1.0.conv1.kernel"].shape[0] == 27
