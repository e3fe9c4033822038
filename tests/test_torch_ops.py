"""The port's ops against the JAX package's, on the CPU: synthetic scenes,
box geometry, voxelization, lookups, the sparse convolutions, FPS and
the RPE table sampling. JAX runs as its own tests run it here (the XLA
gather path of the sparse convs, fps_jax, fps_pallas in interpret mode);
the port runs its kernels' plain versions.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vdetr_tpu.data import ScannetDatasetConfig as JaxScannetConfig
from vdetr_tpu.data.synthetic import SyntheticDetectionDataset as JaxSynth
from vdetr_tpu.geometry import boxes as jboxes
from vdetr_tpu.ops import fps as jfps
from vdetr_tpu.ops import rpe as jrpe
from vdetr_tpu.ops import sparse_conv as jsc
from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
from vdetr_tpu_torch.data.synthetic import SyntheticDetectionDataset
from vdetr_tpu_torch.geometry import boxes as tboxes
from vdetr_tpu_torch.ops import fps as tfps
from vdetr_tpu_torch.ops import rpe as trpe
from vdetr_tpu_torch.ops import sparse_conv as tsc
from vdetr_tpu_torch.ops import voxelize as tvox
from vdetr_tpu_torch.ops.sparse_conv_keyed import (keyed_conv,
                                                   keyed_conv_plain)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the module (vdetr_tpu.ops re-exports a function of the same name)
jvox = importlib.import_module("vdetr_tpu.ops.voxelize")

EXTENT = (128, 128, 64)


def t(a):
    return torch.from_numpy(np.array(a))


def test_synthetic_scenes_equal_jax():
    ours = SyntheticDetectionDataset(ScannetDatasetConfig(), 4096, seed=3)
    ref = JaxSynth(JaxScannetConfig(), 4096, seed=3)
    for idx in range(2):
        a, b = ours[idx], ref[idx]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(ScannetDatasetConfig().mean_size_arr,
                                  JaxScannetConfig().mean_size_arr)


def test_box_corners_match_jax(rng):
    center = rng.randn(2, 7, 3).astype(np.float32)
    size = rng.rand(2, 7, 3).astype(np.float32) + 0.2
    angle = (rng.rand(2, 7).astype(np.float32) - 0.5) * 6
    ref = jboxes.convert_corners_camera2lidar(
        jboxes.box_parametrization_to_corners(center, size, angle))
    got = tboxes.convert_corners_camera2lidar(
        tboxes.box_parametrization_to_corners(t(center), t(size), t(angle)))
    # sin/cos may differ by an ulp between the two libraries
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def make_points(rng, B=2, N=1500, n_invalid=100):
    """Clustered points (many share a voxel), the tail of each row
    invalid."""
    pts = (rng.rand(B, N, 3) * [0.6, 0.5, 0.3] - 0.1).astype(np.float32)
    pts[:, ::3] = pts[:, 1::3]  # exact duplicates
    valid = np.ones((B, N), bool)
    valid[:, N - n_invalid:] = False
    feats = rng.randn(B, N, 4).astype(np.float32)
    return pts, feats, valid


def both_grids(rng, capacity, voxel_size=0.02):
    """The JAX package's voxelize (compiled, as the model runs it) and
    the port's on the same points."""
    pts, feats, valid = make_points(rng)
    jg = jax.jit(lambda p, f, m: jvox.voxelize(
        p, f, m, voxel_size=voxel_size, capacity=capacity,
        extent=EXTENT))(pts, feats, valid)
    tg = tvox.voxelize(t(pts), t(feats), t(valid), voxel_size=voxel_size,
                       capacity=capacity, extent=EXTENT)
    return jg, tg


def assert_grid_sites(jg, tg):
    for name in ("keys", "coords", "valid", "origin"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert (tg.stride, tuple(tg.extent)) == (jg.stride, tuple(jg.extent))


@pytest.mark.parametrize("capacity", [4096, 300], ids=["fits", "overflow"])
def test_voxelize_matches_jax(rng, capacity):
    """Keys, coords, valid masks and the first point's features are
    equal; past capacity both drop the largest keys."""
    jg, tg = both_grids(rng, capacity)
    assert_grid_sites(jg, tg)
    np.testing.assert_array_equal(tg.features.numpy(),
                                  np.asarray(jg.features))
    if capacity == 300:
        assert tg.valid.all()


@pytest.mark.parametrize("voxel_size", [0.01, 0.02])
def test_voxelize_matches_compiled_jax_on_voxel_boundaries(rng, voxel_size):
    """Points whose coordinates are whole multiples of the voxel size,
    where floor(x / v) and floor(x * (1 / v)) part: the compiled JAX
    voxelize (XLA turns the division by the constant voxel size into a
    product with its float32 reciprocal) and the port's put every point
    in the same voxel, with the same keys and features. At the published
    1 cm, 4.22 m is voxel 421 in the compiled model, not 422."""
    v = np.float32(voxel_size)
    x = (np.arange(600) * float(voxel_size)).astype(np.float32)
    edge = x[np.floor(x / v) != np.floor(x * (np.float32(1) / v))]
    assert len(edge) > 10
    pts = rng.choice(edge, (2, 500, 3)).astype(np.float32)
    pts[..., 2] = rng.choice(edge[edge < 2], (2, 500))
    feats = rng.randn(2, 500, 4).astype(np.float32)
    valid = np.ones((2, 500), bool)
    jg = jax.jit(lambda p, f, m: jvox.voxelize(
        p, f, m, voxel_size=voxel_size, capacity=1024))(pts, feats, valid)
    tg = tvox.voxelize(t(pts), t(feats), t(valid), voxel_size=voxel_size,
                       capacity=1024)
    assert_grid_sites(jg, tg)
    np.testing.assert_array_equal(tg.features.numpy(),
                                  np.asarray(jg.features))


def test_downsample_and_upsample_match_jax(rng):
    jg, tg = both_grids(rng, 2048)
    jd, ju = jax.jit(lambda g: (lambda d: (d, jvox.upsample_candidates(
        d, 2048)))(jvox.downsample_grid(g, 512)))(jg)
    td = tvox.downsample_grid(tg, 512)
    assert_grid_sites(jd, td)
    tu = tvox.upsample_candidates(td, 2048)
    assert_grid_sites(ju, tu)


def test_lookup_matches_jax(rng):
    jg, tg = both_grids(rng, 2048)
    q = rng.randint(0, 40 * 128 * 64, size=(2, 700)).astype(np.int32)
    q[:, :300] = np.asarray(jg.keys)[:, :300]  # hits, sentinels included
    ref = jax.jit(jax.vmap(jvox.lookup))(jg.keys, jnp.asarray(q))
    np.testing.assert_array_equal(tvox.lookup(tg.keys, t(q)).numpy(),
                                  np.asarray(ref))


# float32 gather-matmul sums of <= 27 * 16 products, in another order
CONV_ATOL = 1e-5


def _with_features(jg, tg, rng, C):
    f = rng.randn(*tg.keys.shape, C).astype(np.float32)
    f = f * np.asarray(jg.valid)[..., None]
    return jg.replace(features=jnp.asarray(f)), tg.replace(features=t(f))


def _weights(rng, k, cin, cout):
    return (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)


@pytest.mark.parametrize("kind,cin,cout", [
    ("submanifold", 16, 8), ("down3", 3, 16), ("down3", 16, 8),
    ("down1", 16, 8), ("transpose", 16, 8), ("generative", 16, 8)])
def test_sparse_convs_match_jax(rng, kind, cin, cout):
    jg, tg = both_grids(rng, 2048)
    jg, tg = _with_features(jg, tg, rng, cin)
    jit = jax.jit  # each JAX conv one compiled program
    if kind == "submanifold":
        w = _weights(rng, 27, cin, cout)
        ref = jit(lambda g, ww: jsc.sparse_conv(g, ww, 3))(jg, w)
        got = tsc.sparse_conv(tg, t(w), 3)
    elif kind in ("down3", "down1"):
        k = 3 if kind == "down3" else 1
        w = _weights(rng, k ** 3, cin, cout)
        ref = jit(lambda g, ww: jsc.sparse_conv_down(g, ww, 512, k))(jg, w)
        got = tsc.sparse_conv_down(tg, t(w), 512, k)
    else:
        jc, tc = _with_features(jit(lambda g: jvox.downsample_grid(
            g, 512))(jg), tvox.downsample_grid(tg, 512), rng, cin)
        w = _weights(rng, 8, cin, cout)
        if kind == "transpose":
            ref = jit(jsc.sparse_conv_transpose)(jc, jg, w)
            got = tsc.sparse_conv_transpose(tc, tg, t(w))
        else:
            ref = jit(lambda c, ww: jsc.sparse_conv_transpose_generative(
                c, ww, 2048))(jc, w)
            got = tsc.sparse_conv_transpose_generative(tc, t(w), 2048)
    assert_grid_sites(ref, got)
    np.testing.assert_allclose(got.features.numpy(),
                               np.asarray(ref.features), atol=CONV_ATOL)


def test_keyed_conv_wrapper_takes_plain_path_on_cpu(rng):
    jg, tg = both_grids(rng, 1024)
    _, tg = _with_features(jg, tg, rng, 8)
    w = t(_weights(rng, 27, 8, 8))
    args = (tg.features, tg.keys, tg.coords, tg.valid, tg.extent, w)
    before = keyed_conv.launches
    np.testing.assert_array_equal(keyed_conv(*args).numpy(),
                                  keyed_conv_plain(*args).numpy())
    assert keyed_conv.launches == before  # no kernel launch on the CPU


def _padded_cloud(rng, B=2, N=300, n_pad=30):
    xyz = (rng.rand(B, N, 3) * 3 + 0.05).astype(np.float32)
    xyz[:, N - n_pad:] = 0.0  # padding: never picked, never updated
    return xyz


@pytest.mark.parametrize("ref", ["fps_jax", "fps_pallas_interpret"])
def test_fps_matches_jax(rng, ref):
    xyz = _padded_cloud(rng)
    if ref == "fps_jax":
        want = jfps.fps_jax(jnp.asarray(xyz), 64)
    else:
        want = jfps.fps_pallas(jnp.asarray(xyz), 64, interpret=True)
    got = tfps.furthest_point_sample(t(xyz), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["zero-row", "fewer-valid"])
def test_fps_plain_matches_jax_on_edge_rows(rng, kind):
    """A batch row of zeros (fps_jax picks index 0 every step) and rows
    with fewer valid points than npoint (the rest ties at distance 0 and
    -1)."""
    xyz = _padded_cloud(rng)
    if kind == "zero-row":
        xyz[1] = 0.0
    else:
        xyz[:, 20:] = 0.0  # 20 valid points, npoint 64
    want = jfps.fps_jax(jnp.asarray(xyz), 64)
    got = tfps.fps_plain(t(xyz), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fps_plan_picks_the_smallest_register_tier():
    span = tfps.CLUSTER * tfps.THREADS
    assert tfps.fps_plan(1) == (1, False)
    assert tfps.fps_plan(span) == (1, False)
    assert tfps.fps_plan(span + 1) == (2, False)
    assert tfps.fps_plan(3 * span) == (4, False)
    assert tfps.fps_plan(32768, 8, 512) == (8, False)
    assert tfps.fps_plan(32768, 16, 512) == (4, False)
    assert tfps.fps_plan(17 * 8 * 512, 8, 512) == (0, False)  # 16 at most
    assert tfps.fps_plan(33 * 8 * 256, 8, 256) == (0, False)
    assert tfps.fps_plan(300000, 8, 256) == (0, True)


def test_fps_matches_jax_on_lattice_ties(rng):
    """Voxel lattice points have many exactly tied distances; the
    selection only matches fps_jax if the squared distances round the
    same way (fused multiply-adds)."""
    xyz = (rng.randint(0, 30, size=(2, 500, 3)) * 4 + 32).astype(np.float32)
    xyz = (xyz * np.float32(0.01)).astype(np.float32)
    want = jfps.fps_jax(jnp.asarray(xyz), 128)
    got = tfps.fps_plain(t(xyz), 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rpe_quantize_and_coords_table_match_jax(rng):
    d = (rng.randn(1000) * 2).astype(np.float32)
    np.testing.assert_allclose(
        trpe.log_quantize(t(d), 512.0, 4.0).numpy(),
        np.asarray(jrpe.log_quantize(jnp.asarray(d), 512.0, 4.0)),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(trpe.make_coords_table(4.0, 10),
                                  np.asarray(jrpe.make_coords_table(4.0, 10)))


def test_trilinear_sample_matches_jax_and_grid_sample(rng):
    """Against the JAX sampler and, independently, torch's grid_sample
    (align_corners=False, zero padding), points in and beyond [-1, 1]."""
    n, H = 10, 4
    table = rng.randn(n, n, n, H).astype(np.float32)
    p = (rng.rand(3, 500).astype(np.float32) - 0.5) * 2.4
    got = trpe.trilinear_sample(t(table), t(p[0]), t(p[1]), t(p[2]))
    ref = jrpe.trilinear_sample_split(jnp.asarray(table), *map(jnp.asarray, p),
                                      heads_first=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    gs = F.grid_sample(t(table).permute(3, 0, 1, 2)[None],
                       t(p.T).reshape(1, 1, 1, 500, 3), mode="bilinear",
                       padding_mode="zeros", align_corners=False)
    np.testing.assert_allclose(got.numpy(), gs.reshape(H, 500).numpy(),
                               atol=1e-5)



@pytest.mark.parametrize("kind", ["masked_bn", "masked_in", "bn1d"])
def test_norms_match_jax(rng, kind):
    """Eval-mode norms with non-trivial statistics, masked rows zero."""
    from vdetr_tpu.models import norm as jnorm
    from vdetr_tpu_torch.models import norm as tnorm

    C = 6
    x = rng.randn(2, 50, C).astype(np.float32) * 3 + 1
    mask = rng.rand(2, 50) > 0.3
    scale = (1 + 0.2 * rng.randn(C)).astype(np.float32)
    bias = (0.3 * rng.randn(C)).astype(np.float32)
    mean = rng.randn(C).astype(np.float32)
    var = rng.uniform(0.5, 2.0, C).astype(np.float32)
    params = {"params": {"scale": scale, "bias": bias},
              "batch_stats": {"mean": mean, "var": var}}
    if kind == "masked_in":
        ref = jnorm.MaskedInstanceNorm(C).apply(
            {"params": params["params"]}, x, mask)
        mod = tnorm.MaskedInstanceNorm(C)
        target = mod
    elif kind == "masked_bn":
        ref = jnorm.MaskedBatchNorm(C, use_running_average=True).apply(
            params, x, mask)
        mod = tnorm.MaskedBatchNorm(C)
        target = mod.bn
    else:
        ref = jnorm.BatchNorm1d(C, use_running_average=True).apply(params, x)
        mod = tnorm.BatchNorm1d(C)
        target = mod
    with torch.no_grad():
        target.weight.copy_(t(scale))
        target.bias.copy_(t(bias))
        if kind != "masked_in":
            target.running_mean.copy_(t(mean))
            target.running_var.copy_(t(var))
        mod.eval()  # the batch norms take batch statistics in train mode
        got = mod(t(x), t(mask)) if kind != "bn1d" else mod(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
