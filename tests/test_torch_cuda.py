"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes chosen for their edges: channel widths off the
kernel tiles, the 3-channel stem, tiles with no valid row, FPS past the
on-chip distance buffer, ragged query and key counts, corners that do
not pair up. chip_smoke.py checks the published shapes.

Every test here needs an NVIDIA GPU and skips without one. This file
imports no jax, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from vdetr_tpu_torch.ops import fps as tfps
from vdetr_tpu_torch.ops.rpe_attention import (rpe_cross_attention,
                                               rpe_cross_attention_plain)
from vdetr_tpu_torch.ops.sparse_conv_keyed import (keyed_conv,
                                                   keyed_conv_plain)
from vdetr_tpu_torch.ops.voxelize import downsample_grid, voxelize

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def t(a, device):
    return torch.from_numpy(np.array(a)).to(device)


@pytest.mark.parametrize("cin,cout,stride", [(3, 16, 2), (16, 24, 1),
                                             (40, 8, 2), (64, 130, 1),
                                             (256, 72, 1), (300, 64, 2)])
def test_keyed_conv_kernel_matches_plain(rng, cuda, cin, cout, stride):
    """Capacity 4096 holds ~1.4k voxels: whole tiles have no valid row.
    From 256 input channels the offsets are split over three blocks."""
    pts = (rng.rand(2, 1500, 3) * [0.6, 0.5, 0.3]).astype(np.float32)
    g = voxelize(t(pts, cuda), t(pts, cuda), torch.ones(2, 1500, dtype=bool,
                                                        device=cuda),
                 voxel_size=0.02, capacity=4096, extent=(128, 128, 64))
    f = torch.randn(*g.keys.shape, cin, device=cuda) * g.valid[..., None]
    go = downsample_grid(g, 2048) if stride == 2 else g
    q = (go.coords * 2 if stride == 2 else go.coords).contiguous()
    w = t((rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32),
          cuda)
    args = (f.contiguous(), g.keys, q, go.valid, g.extent, w)
    before = keyed_conv.launches
    got = keyed_conv(*args)
    assert keyed_conv.launches == before + 1
    ref = keyed_conv_plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("N", [5, 300, 50000, 120000],
                         ids=["few", "small", "on-chip", "spilled"])
def test_fps_kernel_equals_plain(rng, cuda, N):
    """Fewer points than CTAs, points in the cluster's shared memory, and
    past ~115k points in device memory; lattice points, so exact distance
    ties decide."""
    xyz = (rng.randint(0, 60, size=(2, N, 3)) * 4).astype(np.float32)
    xyz = (xyz * np.float32(0.01)).astype(np.float32)
    xyz[:, -7:] = 0.0
    x = t(xyz, cuda)
    before = tfps.furthest_point_sample.launches
    got = tfps.furthest_point_sample(x, 256)
    assert tfps.furthest_point_sample.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  tfps.fps_plain(x, 256).cpu().numpy())


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("B,nQ,nK", [(2, 16, 64), (1, 13, 100),
                                     (2, 40, 257)],
                         ids=["tiles", "ragged", "many-tiles"])
def test_rpe_kernel_matches_plain(rng, cuda, rotate, B, nQ, nK):
    H, hd, n = 4, 64, 10
    q = rng.randn(B, nQ, H, hd).astype(np.float32) * 0.3
    k = rng.randn(B, nK, hd).astype(np.float32) * 0.3
    v = rng.randn(B, nK, hd).astype(np.float32)
    corners = (rng.rand(B, nQ, 8, 3) * 4).astype(np.float32)  # unpaired
    angles = ((rng.rand(B, nQ) - 0.5) * 6).astype(np.float32)
    key_xyz = (rng.rand(B, nK, 3) * 4).astype(np.float32)
    tables = (rng.randn(8, n, n, n, H) * 0.5).astype(np.float32)
    key_valid = rng.rand(B, nK) > 0.2
    key_valid[0] = False  # a fully masked batch row
    args = [t(a, cuda) for a in (q, k, v, corners, angles, key_xyz, tables,
                                 key_valid)]
    kw = dict(log_scale=512.0, max_value=4.0, rotate=rotate)
    before = rpe_cross_attention.launches
    got = rpe_cross_attention(*args, **kw)
    assert rpe_cross_attention.launches == before + 1
    ref = rpe_cross_attention_plain(*args, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-5, rtol=1e-4)


def test_wrappers_raise_on_inputs_the_kernels_do_not_take(cuda):
    """A CUDA tensor never falls back to the plain version: a layout or
    type the kernel does not take raises."""
    x = torch.rand(2, 64, 3, device=cuda)
    with pytest.raises(ValueError):
        tfps.furthest_point_sample(x.double(), 8)
    with pytest.raises(ValueError):
        tfps.furthest_point_sample(x[:, ::2], 8)  # strided rows
    q = torch.rand(1, 8, 3, 64, device=cuda)  # 3 heads: not built
    k = torch.rand(1, 16, 64, device=cuda)
    with pytest.raises(ValueError):
        rpe_cross_attention(q, k, k, torch.rand(1, 8, 8, 3, device=cuda),
                            torch.rand(1, 8, device=cuda),
                            torch.rand(1, 16, 3, device=cuda),
                            torch.rand(8, 10, 10, 10, 3, device=cuda),
                            log_scale=512.0, max_value=4.0)
