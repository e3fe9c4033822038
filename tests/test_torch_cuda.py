"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes chosen for their edges: channel widths off the
kernel tiles, the 3-channel stem, tiles with no valid row, FPS in each
register tier and past the registers and the shared memory, ragged query and key counts, corners that do
not pair up, a fully masked batch row, dropout; the neighbour map (G)
bit for bit, also on the stem's 131072-row table; the three autograd
Functions on the card against the same Functions on the CPU; and the two
probes of kernel C, the stage ablation (levels 0-5; level 6 is C itself)
and the table contraction; the split-TF32 tile GEMM of A and H at the
published channel widths; D and I in both their forms, bit-equal to each
other and from call to call; C on the decoder's box corners (its shared
x/y quantize), and F on those corners and on C's own training outputs;
F's pair kernel at every head width, on partial bands and tiles, at the
published shape, and its dq, ds and eg bit for bit from launch to
launch; the eval step's NMS (N) bit for bit against its plain loop on
ties, threshold pairs, holes and past 1024 boxes, and a small eval step
on the card against the CPU; the matcher's auction (M) bit for bit
against its plain versions (ties, duplicated rows, no valid row, more
rows than columns, a problem cut at max_iters, the published widths),
the criterion under the auction with no synchronizing call, and the CLI
at a tiny config (train, checkpoint, --test_only --auto_test). chip_smoke.py
checks the published shapes.

Every test here needs an NVIDIA GPU and skips without one. This file
imports no jax, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from vdetr_tpu_torch.geometry.boxes import (box_parametrization_to_corners,
                                            convert_corners_camera2lidar)
from vdetr_tpu_torch.geometry.nms import (nms_3d_samecls_mask,
                                          nms_3d_samecls_mask_plain)
from vdetr_tpu_torch.ops.hungarian import (auction, auction_capacity,
                                           auction_capacity_plain,
                                           auction_launch, auction_plain)
from vdetr_tpu_torch.ops import fps as tfps
from vdetr_tpu_torch.ops.map_kernel import (kernel_map, kernel_map_pair,
                                            neighbour_map, neighbour_map_pair)
from vdetr_tpu_torch.ops.rpe_attention import (rpe_cross_attention,
                                               rpe_cross_attention_ad,
                                               rpe_cross_attention_bwd,
                                               rpe_cross_attention_bwd_plain,
                                               rpe_cross_attention_plain,
                                               rpe_table_sum,
                                               rpe_table_sum_plain)
from vdetr_tpu_torch.ops.sparse_conv_keyed import (keyed_conv,
                                                   keyed_conv_ad,
                                                   keyed_conv_dw,
                                                   keyed_conv_dw_plain,
                                                   keyed_conv_plain)
from vdetr_tpu_torch.ops.sparse_conv_kernel import (mapped_conv,
                                                    mapped_conv_ad,
                                                    mapped_conv_dw,
                                                    mapped_conv_dw_plain,
                                                    mapped_conv_plain)
from vdetr_tpu_torch.ops.voxelize import downsample_grid, voxelize
from vdetr_tpu_torch.tools import dot_micro as tdm
from vdetr_tpu_torch.tools import rpe_ablate as tra
from vdetr_tpu_torch.tools.nms_cases import nms_cases, nms_chain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def t(a, device):
    return torch.from_numpy(np.array(a)).to(device)


def conv_case(rng, cuda, cin, cout, stride, capacity=4096, flat=False):
    """Capacity 4096 holding ~1.4k voxels: whole tiles have no valid row.
    `flat`: every point at one height, so the 18 offsets that step in z
    have no hit."""
    pts = (rng.rand(2, 1500, 3) * [0.6, 0.5, 0.3]).astype(np.float32)
    if flat:
        pts[..., 2] = 0.1
    g = voxelize(t(pts, cuda), t(pts, cuda), torch.ones(2, 1500, dtype=bool,
                                                        device=cuda),
                 voxel_size=0.02, capacity=capacity, extent=(128, 128, 64))
    f = torch.randn(*g.keys.shape, cin, device=cuda) * g.valid[..., None]
    go = downsample_grid(g, capacity // 2) if stride == 2 else g
    q = (go.coords * 2 if stride == 2 else go.coords).contiguous()
    w = t((rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32),
          cuda)
    dout = (torch.randn(*go.keys.shape, cout, device=cuda)
            * go.valid[..., None]).contiguous()
    return (f.contiguous(), g.keys, q, go.valid, g.extent, w), dout


@pytest.mark.parametrize("cin,cout,stride", [(3, 16, 2), (16, 24, 1),
                                             (40, 8, 2), (64, 130, 1),
                                             (256, 72, 1), (300, 64, 2)])
def test_keyed_conv_kernel_matches_plain(rng, cuda, cin, cout, stride):
    """From 64 input channels the offsets are split over three blocks
    (`conv_splits`)."""
    args, _ = conv_case(rng, cuda, cin, cout, stride)
    before = keyed_conv.launches
    got = keyed_conv(*args)
    assert keyed_conv.launches == before + 1
    ref = keyed_conv_plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cin,cout,stride", [(3, 64, 2), (64, 64, 1),
                                             (64, 128, 2), (512, 512, 1),
                                             (40, 8, 1)],
                         ids=["stem", "64-64", "stride-2", "512-512",
                              "ragged"])
def test_keyed_conv_dw_kernel_matches_plain(rng, cuda, cin, cout, stride):
    """Kernel D at the published convs' channel widths (and widths off
    its 64 x 64 tiles), with row splits: f32 sums over ~1.4k rows per
    entry, 1e-5 of the largest."""
    args, dout = conv_case(rng, cuda, cin, cout, stride)
    dargs = args[:5] + (dout,)
    before = keyed_conv_dw.launches
    got = keyed_conv_dw(*dargs)
    assert keyed_conv_dw.launches == before + 1
    ref = keyed_conv_dw_plain(*dargs)
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("stride", [1, 2], ids=["submanifold", "stride-2"])
def test_keyed_conv_function_gradients_kernel_vs_plain(rng, cuda, stride):
    """The autograd Function on the card (kernels A and D, the scatter
    dFeats) against the same Function on the CPU (plain versions)."""
    args, dout = conv_case(rng, cuda, 24, 40, stride)
    res = []
    for dev in (cuda, torch.device("cpu")):
        f = args[0].to(dev).requires_grad_()
        w = args[5].to(dev).requires_grad_()
        out = keyed_conv_ad(f, args[1].to(dev), args[2].to(dev),
                            args[3].to(dev), args[4], w,
                            submanifold=stride == 1)
        res.append([x.cpu() for x in (out.detach(),) + torch.autograd.grad(
            out, (f, w), dout.to(dev))])
    for got, ref in zip(*res):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


def map_args(args):
    """Kernel G's arguments for a conv case's sites."""
    return args[1], args[2], args[3], args[4]


@pytest.mark.parametrize("stride", [1, 2], ids=["submanifold", "stride-2"])
def test_kernel_map_equals_plain(rng, cuda, stride):
    """Kernel G's map bit for bit, two batch rows, tiles with no valid
    row."""
    args, _ = conv_case(rng, cuda, 3, 8, stride)
    before = kernel_map.launches
    got = kernel_map(*map_args(args))
    assert kernel_map.launches == before + 1
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  neighbour_map(*map_args(args)).cpu().numpy())


def test_kernel_map_on_the_stem_table(rng, cuda):
    """The published stem's table: 131072 keys at 1 cm, queries 2 * the
    stem's 65536 sites, and the raw level's own sites; the extent's
    borders are reached (points at both ends of each axis)."""
    pts = (rng.rand(1, 120000, 3) * [4.0, 4.0, 1.5]).astype(np.float32)
    pts[0, :8] = [[0, 0, 0], [4, 4, 1.5], [0, 4, 0], [4, 0, 1.5],
                  [0, 0, 1.5], [4, 4, 0], [2, 0, 0], [0, 2, 1.5]]
    g = voxelize(t(pts, cuda), t(pts, cuda),
                 torch.ones(1, 120000, dtype=bool, device=cuda),
                 voxel_size=0.01, capacity=131072)
    go = downsample_grid(g, 65536)
    assert int(g.valid.sum()) > 100000
    for q, qv in ((go.coords * 2, go.valid), (g.coords, g.valid)):
        margs = (g.keys, q.contiguous(), qv, g.extent)
        np.testing.assert_array_equal(kernel_map(*margs).cpu().numpy(),
                                      neighbour_map(*margs).cpu().numpy())


def test_kernel_map_pair_equals_plain(rng, cuda):
    """Both maps of a stride-2 step in one launch (the level's own map and
    the stride-2 map of 2 * its coords in the finer table), bit for bit,
    two batch rows; one launch counted."""
    pts = t((rng.rand(2, 1500, 3) * [0.6, 0.5, 0.3]).astype(np.float32),
            cuda)
    g = voxelize(pts, pts, torch.ones(2, 1500, dtype=bool, device=cuda),
                 voxel_size=0.02, capacity=4096, extent=(128, 128, 64))
    go = downsample_grid(g, 2048)
    pargs = (g.keys, g.extent, go.keys, go.coords, go.valid, go.extent)
    before = kernel_map.launches
    got = kernel_map_pair(*pargs)
    assert kernel_map.launches == before + 1
    for a, b in zip(got, neighbour_map_pair(*pargs)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_kernel_map_windows_that_overflow(rng, cuda):
    """Queries spread thinly over a dense table (every 64th site of a
    16384-site level, so a block's rows span the whole table): the
    block's window overflows the kernel's 8192-key staging and the search
    runs on the table in global memory; the map is still exact. Also a level's
    own map and a stride-2 map on the same table, whose windows fit."""
    pts = (rng.rand(1, 40000, 3) * [1.6, 1.6, 0.6]).astype(np.float32)
    g = voxelize(t(pts, cuda), t(pts, cuda),
                 torch.ones(1, 40000, dtype=bool, device=cuda),
                 voxel_size=0.02, capacity=16384, extent=(128, 128, 64))
    assert int(g.valid.sum()) == 16384
    go = downsample_grid(g, 8192)
    for q, qv in ((g.coords[:, ::64], g.valid[:, ::64]),
                  (g.coords, g.valid), (go.coords * 2, go.valid)):
        margs = (g.keys, q.contiguous(), qv.contiguous(), g.extent)
        np.testing.assert_array_equal(kernel_map(*margs).cpu().numpy(),
                                      neighbour_map(*margs).cpu().numpy())


@pytest.mark.parametrize("cin,cout,stride", [(3, 64, 2), (64, 64, 1),
                                             (64, 128, 2), (512, 512, 1),
                                             (40, 8, 1)],
                         ids=["stem", "64-64", "stride-2", "512-512",
                              "ragged"])
def test_mapped_conv_and_dw_kernels_match_plain(rng, cuda, cin, cout,
                                                stride):
    """Kernels H and I at the published convs' channel widths (and widths
    off their 64 x 64 tiles) over kernel G's map; H also against kernel A,
    which runs the same tile GEMM."""
    args, dout = conv_case(rng, cuda, cin, cout, stride)
    nbr = kernel_map(*map_args(args))
    before = (mapped_conv.launches, mapped_conv_dw.launches)
    got = mapped_conv(args[0], nbr, args[5])
    dw = mapped_conv_dw(args[0], nbr, dout)
    assert (mapped_conv.launches, mapped_conv_dw.launches) == (
        before[0] + 1, before[1] + 1)
    ref = mapped_conv_plain(args[0], nbr, args[5])
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.cpu().numpy(),
                               keyed_conv(*args).cpu().numpy(),
                               atol=1e-5, rtol=1e-5)
    dw_ref = mapped_conv_dw_plain(args[0], nbr, dout)
    np.testing.assert_allclose(dw.cpu().numpy(), dw_ref.cpu().numpy(),
                               atol=1e-5 * float(dw_ref.abs().max()), rtol=0)


@pytest.mark.parametrize("cin,cout,stride,capacity,flat", [
    (3, 64, 2, 4096, False), (3, 64, 2, 4003, True), (64, 64, 1, 4001, True),
    (40, 8, 1, 4096, True), (512, 512, 1, 4096, False),
    (5, 7, 2, 1000, False)],
    ids=["stem", "stem-flat-ragged", "64-flat-ragged", "ragged-flat", "512",
         "odd-widths"])
def test_dw_kernels_match_plain_and_each_other_bit_for_bit(
        rng, cuda, cin, cout, stride, capacity, flat):
    """Kernels D and I at B = 2: the dense form (the stem's 3 channels, all
    27 offsets in a block) and the per-offset form over the rulebook; a
    flat layer, whose 18 offsets that step in z have no hit; row counts
    off the 32-row stage; widths off the 16-byte copies. Each within
    chip_smoke's 2e-5 of max|ref| of its plain version, I bit-equal to D
    on the same neighbours, and two calls of each bit-equal."""
    args, dout = conv_case(rng, cuda, cin, cout, stride, capacity, flat)
    nbr = kernel_map(*map_args(args))
    if flat:
        hits = (nbr < args[0].shape[1]).sum((0, 2)).reshape(3, 3, 3)
        assert int(hits.sum()) > 0 and int(hits[:, :, 0].sum()) == 0
    d = [keyed_conv_dw(*args[:5], dout) for _ in range(2)]
    i = [mapped_conv_dw(args[0], nbr, dout) for _ in range(2)]
    ref = mapped_conv_dw_plain(args[0], nbr, dout)
    tol = 2e-5 * float(ref.abs().max())
    assert float((d[0] - ref).abs().max()) <= tol
    assert torch.equal(d[0], d[1]) and torch.equal(i[0], i[1])
    assert torch.equal(i[0], d[0])


@pytest.mark.parametrize("cin,cout,stride,capacity", [
    (3, 64, 2, 4096), (64, 64, 1, 4096), (128, 128, 1, 4096),
    (512, 512, 1, 4096), (64, 64, 1, 4001), (3, 64, 2, 4003)],
    ids=["stem", "64", "128", "512-splits", "64-ragged-V", "stem-ragged-V"])
def test_conv_tile_split_tf32_matches_plain(rng, cuda, cin, cout, stride,
                                            capacity):
    """The tensor-core tile GEMM that kernels A and H share, within
    chip_smoke's 1e-4 of max(1, max|ref|) of the f32 plain version: the
    stem's 3-channel rows (4-byte copies, one k8 step), 64 and 128
    channels (16-byte copies), 512 (offsets split over six blocks),
    tiles with no hit (~1.4k voxels in 4096 rows) and row counts off the
    64-row tile; H bit-equal to A."""
    args, _ = conv_case(rng, cuda, cin, cout, stride, capacity)
    valid = args[3]
    assert bool((~valid[:, -64:]).all())  # the last tile has no hit
    ref = keyed_conv_plain(*args)
    got = keyed_conv(*args)
    tol = 1e-4 * max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= tol
    nbr = kernel_map(*map_args(args))
    assert torch.equal(mapped_conv(args[0], nbr, args[5]), got)
    assert float(got[~valid].abs().max()) == 0.0


@pytest.mark.parametrize("stride", [1, 2], ids=["submanifold", "stride-2"])
def test_mapped_conv_function_gradients_kernel_vs_plain(rng, cuda, stride):
    """The mapped autograd Function on the card (kernels H and I, the
    scatter dFeats) against the same Function on the CPU."""
    args, dout = conv_case(rng, cuda, 24, 40, stride)
    nbr = neighbour_map(*map_args(args))
    res = []
    for dev in (cuda, torch.device("cpu")):
        f = args[0].to(dev).requires_grad_()
        w = args[5].to(dev).requires_grad_()
        out = mapped_conv_ad(f, nbr.to(dev), w, submanifold=stride == 1)
        res.append([x.cpu() for x in (out.detach(),) + torch.autograd.grad(
            out, (f, w), dout.to(dev))])
    for got, ref in zip(*res):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


_FPS_SPAN = tfps.CLUSTER * tfps.THREADS  # points a register tier adds
_FPS_TIERS = [t for t in tfps.TIERS
              if tfps.fps_plan(t * _FPS_SPAN) == (t, False)]


def _fps_case(rng, case):
    """(xyz, npoint) of a kernel-B case: lattice points (exact distance
    ties decide), N off every multiple of the cluster's threads."""
    top = _FPS_TIERS[-1]
    B, npoint, n_valid = 2, 256, None
    if case.startswith("tier-"):
        tier = int(case[5:])
        N = (_FPS_SPAN - 37 if tier == 1
             else (tier // 2) * _FPS_SPAN + _FPS_SPAN // 3)
        assert tfps.fps_plan(N) == (tier, False)
    else:
        N = {"few": 5, "fewer-valid": 3000, "zero-row": 2000,
             "on-chip": top * _FPS_SPAN + 1234,
             "spilled": (tfps._POINT_BYTES_MAX // (16 * tfps.THREADS) + 1)
             * _FPS_SPAN + 7,
             "published-512": 32768}[case]
        if case == "fewer-valid":
            n_valid = 100
        if case == "published-512":
            B, npoint = 1, 512
        want = {"on-chip": (0, False), "spilled": (0, True)}.get(case)
        assert want is None or tfps.fps_plan(N) == want
    xyz = (rng.randint(0, 60, size=(B, N, 3)) * 4).astype(np.float32)
    xyz = (xyz * np.float32(0.01)).astype(np.float32)
    xyz[:, -7:] = 0.0
    if n_valid is not None:
        xyz[:, n_valid:] = 0.0
    if case == "zero-row":
        xyz[1] = 0.0
    return xyz, npoint


@pytest.mark.parametrize("case", [f"tier-{t}" for t in _FPS_TIERS] + [
    "few", "fewer-valid", "zero-row", "on-chip", "spilled", "published-512"])
def test_fps_kernel_equals_plain(rng, cuda, case):
    """Each register tier of the wrapper's form; fewer points than CTAs;
    fewer valid points than npoint; a batch row of zeros (index 0 every
    step, as fps_jax picks); past the registers, the points in shared
    memory, and past that in device memory; the published N at npoint
    512. Tolerance 0."""
    xyz, npoint = _fps_case(rng, case)
    x = t(xyz, cuda)
    before = tfps.furthest_point_sample.launches
    got = tfps.furthest_point_sample(x, npoint)
    assert tfps.furthest_point_sample.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  tfps.fps_plain(x, npoint).cpu().numpy())
    if case == "zero-row":
        assert int(got[1].abs().sum()) == 0


def test_fps_kernel_refuses_what_it_cannot_take(rng, cuda):
    """No fallback: a form that does not exist raises, and so does the
    exchange floor off the published shape."""
    x = t(rng.rand(1, 1000, 3).astype(np.float32) + 0.1, cuda)
    with pytest.raises(RuntimeError):
        tfps.fps_launch(x, 16, threads=64)
    with pytest.raises(RuntimeError):
        tfps.fps_launch(x, 16, cluster=4)
    with pytest.raises(RuntimeError):
        tfps.fps_launch(x, 16, floor=True)
    with pytest.raises(ValueError):
        tfps.furthest_point_sample(x[:, :0].contiguous(), 16)


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


def rpe_args(rng, cuda, B, nQ, nK, H=4, hd=64, n=10):
    q = rng.randn(B, nQ, H, hd).astype(np.float32) * 0.3
    k = rng.randn(B, nK, hd).astype(np.float32) * 0.3
    v = rng.randn(B, nK, hd).astype(np.float32)
    corners = (rng.rand(B, nQ, 8, 3) * 4).astype(np.float32)
    angles = ((rng.rand(B, nQ) - 0.5) * 6).astype(np.float32)
    key_xyz = (rng.rand(B, nK, 3) * 4).astype(np.float32)
    tables = (rng.randn(8, n, n, n, H) * 0.5).astype(np.float32)
    key_valid = rng.rand(B, nK) > 0.2
    key_valid[0] = False  # a fully masked batch row
    return [t(a, cuda) for a in (q, k, v, corners, angles, key_xyz, tables,
                                 key_valid)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rotate", [False, True])
def test_rpe_train_forward_stats_match_plain(rng, cuda, rate, rotate):
    """Kernel C's training form: the output under dropout, the row
    log-sum-exp (0 on the fully masked row) and the stored logits."""
    args = rpe_args(rng, cuda, 2, 40, 257)
    seed = torch.tensor([5], dtype=torch.int64, device=cuda)
    kw = dict(log_scale=512.0, max_value=4.0, rotate=rotate,
              dropout_rate=rate, seed=seed, return_stats=True)
    got = rpe_cross_attention(*args, **kw)
    ref = rpe_cross_attention_plain(*args, **kw)
    assert float(got[1][0].abs().max()) == 0.0
    valid = args[7][:, None, None, :].expand_as(ref[2])
    for g, r in ((got[0], ref[0]), (got[1], ref[1]),
                 (got[2][valid], ref[2][valid])):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,nQ,nK,rotate", [(2, 16, 64, False),
                                            (1, 13, 100, True),
                                            (2, 40, 257, False)],
                         ids=["tiles", "ragged-rotated", "many-tiles"])
def test_rpe_bwd_kernel_matches_plain(rng, cuda, rate, B, nQ, nK, rotate):
    """Kernel F against its plain version from the same stored logits
    and lse: dq, dtables (shared-memory and global atomics), ds, eg."""
    args = rpe_args(rng, cuda, B, nQ, nK)
    seed = torch.tensor([3], dtype=torch.int64, device=cuda)
    kw = dict(log_scale=512.0, max_value=4.0, rotate=rotate,
              dropout_rate=rate, seed=seed)
    out, lse, logits = rpe_cross_attention_plain(*args, return_stats=True,
                                                 **kw)
    dout = torch.randn_like(out)
    bargs = (args[1], args[2], args[3], args[4], args[5], args[7], out,
             dout, logits, lse, 10)
    before = rpe_cross_attention_bwd.launches
    got = rpe_cross_attention_bwd(*bargs, **kw)
    assert rpe_cross_attention_bwd.launches == before + 1
    ref = rpe_cross_attention_bwd_plain(*bargs, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=0,
                                   atol=2e-5 * max(1.0, float(r.abs().max())))


def rpe_box_args(rng, cuda, B, nQ, nK, aligned):
    """rpe_args with the decoder's corners: boxes in a room through
    box_parametrization_to_corners and convert_corners_camera2lidar, so
    corners i and i + 4 share x and y and the table kernel quantizes them
    once; a tenth of the keys masked."""
    args = rpe_args(rng, cuda, B, nQ, nK)
    centers = t((rng.rand(B, nQ, 3) * [4.0, 4.0, 2.0]).astype(np.float32),
                cuda)
    sizes = t((rng.rand(B, nQ, 3) * 1.5 + 0.1).astype(np.float32), cuda)
    angles = (torch.zeros(B, nQ, device=cuda) if aligned else
              t(((rng.rand(B, nQ) - 0.5) * 6.2).astype(np.float32), cuda))
    corners = convert_corners_camera2lidar(
        box_parametrization_to_corners(centers, sizes, angles)).contiguous()
    assert torch.equal(corners[:, :, :4, :2], corners[:, :, 4:, :2])
    args[3], args[4] = corners, angles
    args[5] = t((rng.rand(B, nK, 3) * [4.0, 4.0, 2.5]).astype(np.float32),
                cuda)
    args[7] = t(rng.rand(B, nK) > 0.1, cuda)
    return args


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rotate,aligned", [(False, True), (True, True),
                                            (True, False)],
                         ids=["aligned", "aligned-rotate", "rotated"])
@pytest.mark.parametrize("B,nQ,nK", [(1, 40, 1000), (2, 33, 257)],
                         ids=["key-shares", "ragged"])
def test_rpe_bwd_kernel_on_box_corners(rng, cuda, rate, rotate, aligned, B,
                                       nQ, nK):
    """Kernel F on the decoder's box corners, the table kernel's shared
    x/y quantize taken: axis-aligned boxes with and without the rotation
    applied, rotated boxes, masked keys, dropout 0 and 0.1, the keys
    split over many blocks; against its plain version."""
    args = rpe_box_args(rng, cuda, B, nQ, nK, aligned)
    seed = torch.tensor([9], dtype=torch.int64, device=cuda)
    kw = dict(log_scale=512.0, max_value=4.0, rotate=rotate,
              dropout_rate=rate, seed=seed)
    out, lse, logits = rpe_cross_attention_plain(*args, return_stats=True,
                                                 **kw)
    dout = torch.randn_like(out)
    bargs = (args[1], args[2], args[3], args[4], args[5], args[7], out,
             dout, logits, lse, 10)
    got = rpe_cross_attention_bwd(*bargs, **kw)
    ref = rpe_cross_attention_bwd_plain(*bargs, **kw)
    assert float(ref[1].abs().max()) > 0.0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=0,
                                   atol=2e-5 * max(1.0, float(r.abs().max())))


@pytest.mark.parametrize("rotate,aligned", [(False, True), (True, False)],
                         ids=["aligned", "rotated"])
@pytest.mark.parametrize("B,nQ,nK", [(2, 13, 257), (1, 40, 1000)],
                         ids=["ragged", "key-groups"])
def test_rpe_kernel_on_box_corners_matches_plain(rng, cuda, rotate, aligned,
                                                 B, nQ, nK):
    """Kernel C on the decoder's box corners, where corners i and i + 4
    share x and y and the kernel quantizes them once; every third query
    has its first pair broken (the full quantize beside the shared one in
    a block); masked keys, key counts off the 32-key tile of each of the
    four key groups, ragged query counts at B = 2."""
    args = rpe_box_args(rng, cuda, B, nQ, nK, aligned)
    args[3] = args[3].clone()
    args[3][:, ::3, 4, 0] += 0.01
    kw = dict(log_scale=512.0, max_value=4.0, rotate=rotate)
    got = rpe_cross_attention(*args, **kw)
    ref = rpe_cross_attention_plain(*args, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("rotate", [False, True])
def test_rpe_bwd_kernel_on_kernel_c_stats(rng, cuda, rotate):
    """Kernel F from kernel C's own training outputs (dropout 0.1, box
    corners, masked keys): C's output, lse and logits against the plain
    forward's, then F on C's against F's plain version on the plain
    forward's."""
    args = rpe_box_args(rng, cuda, 2, 33, 257, aligned=False)
    seed = torch.tensor([21], dtype=torch.int64, device=cuda)
    kw = dict(log_scale=512.0, max_value=4.0, rotate=rotate,
              dropout_rate=0.1, seed=seed)
    got = rpe_cross_attention(*args, return_stats=True, **kw)
    ref = rpe_cross_attention_plain(*args, return_stats=True, **kw)
    valid = args[7][:, None, None, :].expand_as(ref[2])
    for g, r in ((got[0], ref[0]), (got[1], ref[1]),
                 (got[2][valid], ref[2][valid])):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   atol=2e-5, rtol=1e-4)
    dout = torch.randn_like(ref[0])
    common = (args[1], args[2], args[3], args[4], args[5], args[7])
    bwd = rpe_cross_attention_bwd(*common, got[0], dout, got[2], got[1], 10,
                                  **kw)
    bwd_ref = rpe_cross_attention_bwd_plain(*common, ref[0], dout, ref[2],
                                            ref[1], 10, **kw)
    for g, r in zip(bwd, bwd_ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=0,
                                   atol=2e-5 * max(1.0, float(r.abs().max())))


def rpe_bwd_run(rng, cuda, B, nQ, nK, rate, hd=64, repeat=False):
    """Kernel F and its plain version from the plain forward's logits and
    lse on rpe_args (a fully masked batch row); with `repeat`, F twice."""
    args = rpe_args(rng, cuda, B, nQ, nK, hd=hd)
    seed = torch.tensor([17], dtype=torch.int64, device=cuda)
    kw = dict(log_scale=512.0, max_value=4.0, rotate=True,
              dropout_rate=rate, seed=seed)
    out, lse, logits = rpe_cross_attention_plain(*args, return_stats=True,
                                                 **kw)
    dout = torch.randn_like(out)
    bargs = (args[1], args[2], args[3], args[4], args[5], args[7], out,
             dout, logits, lse, 10)
    got = [rpe_cross_attention_bwd(*bargs, **kw)
           for _ in range(2 if repeat else 1)]
    return got, rpe_cross_attention_bwd_plain(*bargs, **kw)


def assert_bwd_close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=0,
                                   atol=2e-5 * max(1.0, float(r.abs().max())))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("hd", [8, 16, 32, 64, 128])
def test_rpe_pair_kernel_every_head_width(rng, cuda, rate, hd):
    """F's pair kernel at every head width it is built for (dO split in
    registers, one or two dQ partial sums), with a query count off its
    16-query band, a key count off its 32-key tile and odd (one-by-one
    logit reads), a fully masked batch row, several key shares."""
    (got,), ref = rpe_bwd_run(rng, cuda, 2, 21, 203, rate, hd=hd)
    assert float(ref[0][0].abs().max()) == 0.0  # the masked row: ds = 0
    np.testing.assert_array_equal(got[3][0].cpu().numpy(),
                                  ref[3][0].cpu().numpy())
    assert_bwd_close(got, ref)


@pytest.mark.parametrize("B,nQ,nK", [(1, 5, 7), (2, 16, 32), (1, 33, 96),
                                     (3, 48, 1000)],
                         ids=["under-one-tile", "one-band-one-tile",
                              "even-off-band", "three-rows-shares"])
def test_rpe_pair_kernel_bands_tiles_and_shares(rng, cuda, B, nQ, nK):
    """F's pair kernel on whole and partial bands and tiles, eight-byte
    logit reads (even key counts) and one key share or several."""
    (got,), ref = rpe_bwd_run(rng, cuda, B, nQ, nK, 0.1)
    assert_bwd_close(got, ref)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_rpe_bwd_kernel_at_the_published_shape(rng, cuda, rate):
    """Kernel F at the decoder's shape (B 1, nQ 1024, nK 4096, 4 heads of
    64): six key shares added by the fixed-order sum."""
    (got,), ref = rpe_bwd_run(rng, cuda, 1, 1024, 4096, rate)
    assert_bwd_close(got, ref)


@pytest.mark.parametrize("B,nQ,nK", [(1, 64, 4096), (2, 21, 203),
                                     (1, 1024, 4096)],
                         ids=["eight-shares", "ragged", "published"])
def test_rpe_bwd_dq_ds_eg_repeat_bit_for_bit(rng, cuda, B, nQ, nK):
    """Two launches on the same inputs give the same dq, dtables, ds and
    eg bit for bit: the key shares' dQ is added in share order, each
    table block sums in integers and the blocks' slices are added in
    slice order, with no global atomics."""
    (first, second), ref = rpe_bwd_run(rng, cuda, B, nQ, nK, 0.1,
                                       repeat=True)
    for i in range(4):
        assert torch.equal(first[i], second[i]), i
    assert_bwd_close(first, ref)
    assert_bwd_close(second, ref)


def test_rpe_table_sum_equals_plain_bit_for_bit(rng, cuda):
    """The slices' sum in slice order: the plain version adds them in the
    same order, so the two agree bit for bit; one launch counted."""
    slices = t(rng.randn(37, 8, 10, 10, 10, 4).astype(np.float32), cuda)
    before = rpe_table_sum.launches
    got = rpe_table_sum(slices)
    assert rpe_table_sum.launches == before + 1
    assert torch.equal(got, rpe_table_sum_plain(slices))


def test_rpe_bwd_with_no_keys_gives_zero_dq(rng, cuda):
    """Kernel F with no keys: dq is the empty sum, zeros, though its
    buffer comes from torch.empty (here over a block just freed full of
    NaN); ds and eg are empty and dtables stays zero."""
    B, nQ, H, hd, n = 2, 21, 4, 64, 10

    def rnd(*shape):
        return t(rng.randn(*shape).astype(np.float32), cuda)

    out, dout = rnd(B, nQ, H, hd), rnd(B, nQ, H, hd)
    k, v = rnd(B, 0, hd), rnd(B, 0, hd)
    corners = t((rng.rand(B, nQ, 8, 3) * 4).astype(np.float32), cuda)
    angles = rnd(B, nQ)
    key_xyz = rnd(B, 0, 3)
    key_valid = torch.zeros(B, 0, dtype=torch.bool, device=cuda)
    logits = rnd(B, H, nQ, 0)
    lse = torch.zeros(B, nQ, H, device=cuda)
    nan_block = torch.full_like(dout, float("nan"))
    del nan_block
    dq, dtables, ds, eg = rpe_cross_attention_bwd(
        k, v, corners, angles, key_xyz, key_valid, out, dout, logits, lse, n,
        log_scale=512.0, max_value=4.0, rotate=True, dropout_rate=0.1,
        seed=torch.tensor([3], dtype=torch.int64, device=cuda))
    assert torch.equal(dq, torch.zeros_like(dq))
    assert torch.equal(dtables, torch.zeros_like(dtables))
    assert ds.shape == eg.shape == (B, H, nQ, 0)


def test_rpe_function_gradients_kernel_vs_plain(rng, cuda):
    """The autograd Function with dropout on the card (kernels C and F)
    against the same Function on the CPU (plain versions): the hash
    mask is the same on both."""
    args = rpe_args(rng, cuda, 2, 24, 130)
    dout = torch.randn(args[0].shape, device=cuda)
    res = []
    for dev in (cuda, torch.device("cpu")):
        a = [x.to(dev) for x in args]
        leaves = [a[i].requires_grad_() for i in (0, 1, 2, 6)]
        out = rpe_cross_attention_ad(
            a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], log_scale=512.0,
            max_value=4.0, rotate=True, dropout_rate=0.2,
            seed=torch.tensor([11], dtype=torch.int64, device=dev))
        res.append([x.cpu() for x in (out.detach(),) + torch.autograd.grad(
            out, leaves, dout.to(dev))])
    for got, ref in zip(*res):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=2e-5 * max(1.0, float(ref.abs().max())))


@pytest.mark.parametrize("level", range(6))
@pytest.mark.parametrize("nq,nk,scale", [(64, 256, 1.0), (37, 257, 0.05)],
                         ids=["tiles", "ragged-soft"])
def test_rpe_ablate_kernel_matches_plain(cuda, level, nq, nk, scale):
    """Each ablation level at the tool's coordinates and, with ragged
    query and key counts, at coordinates scaled down so that the softmax
    of levels 1 and 2 is not saturated."""
    args = tra.make_inputs(nq, nk, cuda, scale=scale)
    before = tra.rpe_ablate.launches
    got = tra.rpe_ablate(level, *args)
    assert tra.rpe_ablate.launches == before + 1
    ref = tra.rpe_ablate_plain(level, *args)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=tra.rounding_tol(level, *args))


def test_rpe_ablate_level6_is_kernel_c(cuda):
    args = tra.make_inputs(64, 256, cuda)
    before = rpe_cross_attention.launches
    got = tra.rpe_ablate(6, *args)
    assert rpe_cross_attention.launches == before + 1
    q, k, v, corners, key_xyz, tables = args
    want = rpe_cross_attention(q, k, v, corners, None, key_xyz, tables, None,
                               log_scale=512.0, max_value=4.0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("nc,K,M,E", [(8, 100, 40, 512), (3, 17, 5, 70),
                                      (1, 800, 40, 300), (8, 128, 128, 256),
                                      (2, 33, 131, 67)],
                         ids=["tool-K", "ragged", "one-corner", "tool-M128",
                              "two-block-rows"])
def test_dot_micro_kernel_matches_plain_and_einsum(cuda, nc, K, M, E):
    T = torch.rand(nc, K, M, device=cuda)
    P = torch.rand(K, E, device=cuda)
    before = tdm.dot_micro.launches
    got = tdm.dot_micro(T, P)
    assert tdm.dot_micro.launches == before + 1
    rtol = tdm.rounding_rtol(T)
    for ref in (tdm.dot_micro_plain(T, P), tdm.dot_micro_library(T, P)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=rtol, atol=0)


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
    f = torch.rand(1, 16, 8, device=cuda)
    keys = torch.arange(16, dtype=torch.int32, device=cuda)[None]
    coords = torch.zeros(1, 16, 3, dtype=torch.int32, device=cuda)
    valid = torch.ones(1, 16, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):  # a strided dout
        keyed_conv_dw(f, keys, coords, valid, (4, 4, 4),
                      torch.rand(1, 16, 5, device=cuda)[..., :4])
    with pytest.raises(ValueError):  # int64 queries
        kernel_map(keys, coords.long(), valid, (4, 4, 4))
    with pytest.raises(ValueError):  # keys past int32
        kernel_map(keys, coords, valid, (2048, 2048, 1024))
    nbr = kernel_map(keys, coords, valid, (4, 4, 4))
    w = torch.rand(27, 8, 4, device=cuda)
    with pytest.raises(ValueError):  # an int64 map
        mapped_conv(f, nbr.long(), w)
    with pytest.raises(ValueError):  # a map of 26 offsets
        mapped_conv(f, nbr[:, :26].contiguous(), w)
    with pytest.raises(ValueError):  # weights of another width
        mapped_conv(f, nbr, torch.rand(27, 9, 4, device=cuda))
    with pytest.raises(ValueError):  # a dout of another length
        mapped_conv_dw(f, nbr, torch.rand(1, 15, 4, device=cuda))
    with pytest.raises(ValueError):  # a CPU map with CUDA features
        mapped_conv(f, nbr.cpu(), w)
    args = tra.make_inputs(16, 64, cuda)
    with pytest.raises(ValueError):  # no level 7
        tra.rpe_ablate(7, *args)
    with pytest.raises(ValueError):  # heads of width 32: not built
        tra.rpe_ablate(2, args[0][..., :32].contiguous(), args[1][..., :32]
                       .contiguous(), args[2][..., :32].contiguous(),
                       *args[3:])
    with pytest.raises(ValueError):  # a strided P
        tdm.dot_micro(torch.rand(2, 5, 4, device=cuda),
                      torch.rand(5, 12, device=cuda)[:, ::2])


@pytest.mark.parametrize("route", ["keyed", "mapped"])
def test_small_train_steps_repeat_bit_for_bit(cuda, route):
    """A small model's train step on the card, dropout on: two backwards
    from one state, batch and seed give the same gradients bit for bit,
    and two whole steps (clip and AdamW included) the same parameters
    (`vdetr_tpu_torch.tools.determinism`)."""
    from vdetr_tpu_torch.config import VDETRConfig
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.data.synthetic import (SyntheticDetectionDataset,
                                                collate)
    from vdetr_tpu_torch.models.vdetr import build_model
    from vdetr_tpu_torch.tools.determinism import grad_spread, step_twice
    from vdetr_tpu_torch.train.engine import Trainer

    cfg = VDETRConfig(
        voxel_capacity=2048, min_stage_capacity=128,
        grid_extent=(128, 128, 64), preenc_npoints=128, nqueries=32,
        dec_nlayers=3, dec_dim=32, dec_ffn_dim=32, dec_nhead=4, rpe_dim=16,
        inplanes=8, enc_dim=32, num_points=1024, voxel_size=0.05,
        repeat_num=2, matcher_impl="jv", warm_lr_epochs=0, max_epoch=10,
        base_lr=1e-3)
    ds = ScannetDatasetConfig()
    model = build_model(cfg, ds, generator=torch.Generator().manual_seed(0),
                        device=cuda, conv_route=route)
    trainer = Trainer(cfg, model, ds, steps_per_epoch=10, device=cuda)
    data = SyntheticDetectionDataset(ds, cfg.num_points, seed=0)
    trainer.train_step(collate([data[0], data[1]]),
                       torch.Generator(device=cuda).manual_seed(0))
    batch = collate([data[2], data[3]])
    spread = grad_spread(trainer, batch)
    assert spread["differing"] == []
    differ, count = step_twice(trainer, batch)
    assert count > 100 and differ == []


@pytest.mark.parametrize("old_type", [False, True], ids=["iou", "old_type"])
@pytest.mark.parametrize("B,K", [(1, 1024), (4, 1024), (3, 37), (1, 1),
                                 (2, 1500), (1, 5000), (1, 13000),
                                 (1, 1000), (1, 4097), (1, 16384)])
def test_nms_kernel_equals_plain_loop(rng, cuda, B, K, old_type):
    """Kernel N's keep mask bit for bit against the literal loop on the
    card, on `tools/nms_cases.py`'s sets (exact score ties, pairs at
    overlap exactly 0.25, holes in `valid`): one tile of 64 boxes and
    less, K not a multiple of 64 (a last tile of 40 boxes, of 1), fewer
    and more than 32 words a row (the scan's lanes split over the kept
    rows, or over the words alone) up to the most it takes (16384: 256
    words a row, a 16 MB mask), with one scene wholly invalid where
    B > 1."""
    aabbs, scores, classes, valid = (torch.from_numpy(a).to(cuda)
                                     for a in nms_cases(rng, B, K))
    valid = valid.clone()
    if B > 1:
        valid[-1] = False
    before = nms_3d_samecls_mask.launches
    got = nms_3d_samecls_mask(aabbs, scores, classes, valid, 0.25, old_type)
    torch.cuda.synchronize()
    assert nms_3d_samecls_mask.launches == before + 1
    want = nms_3d_samecls_mask_plain(aabbs, scores, classes, valid, 0.25,
                                     old_type)
    assert torch.equal(got, want)
    if B > 1:
        assert not got[-1].any()
    assert bool(got[0].any()) == bool(valid[0].any())


@pytest.mark.parametrize("old_type", [False, True], ids=["iou", "old_type"])
@pytest.mark.parametrize("B,K", [(1, 200), (2, 1024), (1, 4097)])
def test_nms_kernel_walks_chains_its_rounds_do_not_settle(rng, cuda, B, K,
                                                         old_type):
    """Kernel N on chains in which each box kills the next
    (`tools/nms_cases.py`'s `nms_chain`): every tile's fate chain outlasts
    the scan's rounds, so it walks each tile in order; the keep mask
    equals the loop's bit for bit, every other box of each chain."""
    aabbs, scores, classes, valid = (torch.from_numpy(a).to(cuda)
                                     for a in nms_chain(rng, B, K))
    got = nms_3d_samecls_mask(aabbs, scores, classes, valid, 0.25, old_type)
    want = nms_3d_samecls_mask_plain(aabbs, scores, classes, valid, 0.25,
                                     old_type)
    assert torch.equal(got, want)
    assert int(got.sum()) == B * ((K + 1) // 2)


def test_nms_kernel_refuses_what_it_cannot_take(cuda):
    K = 16 * 1024 + 1
    args = (torch.rand(1, K, 6, device=cuda), torch.rand(1, K, device=cuda),
            torch.zeros(1, K, dtype=torch.int64, device=cuda),
            torch.ones(1, K, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):
        nms_3d_samecls_mask(*args, 0.25)
    with pytest.raises(ValueError):  # float64 boxes
        nms_3d_samecls_mask(args[0][:, :8].double(), args[1][:, :8],
                            args[2][:, :8], args[3][:, :8], 0.25)


@pytest.mark.parametrize("route", ["keyed", "mapped"])
def test_small_eval_step_on_the_card_equals_cpu(cuda, route):
    """A small model's eval step with `test_only` (empty-box removal on),
    on the card (kernels, N among them, launched once) against the same
    step on the CPU (plain versions): the keep mask equal, the outputs
    within 1e-3 (f32 rounding through ~40 layers, as the forward's
    check)."""
    import copy

    from vdetr_tpu_torch.config import VDETRConfig
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.models.vdetr import build_model
    from vdetr_tpu_torch.train.engine import Trainer

    cfg = VDETRConfig(
        voxel_capacity=2048, min_stage_capacity=128,
        grid_extent=(128, 128, 64), preenc_npoints=128, nqueries=64,
        dec_nlayers=3, dec_dim=32, dec_ffn_dim=32, dec_nhead=4, rpe_dim=16,
        inplanes=8, enc_dim=32, num_points=512, matcher_impl="jv",
        test_only=True)
    ds = ScannetDatasetConfig()
    gen = torch.Generator().manual_seed(3)
    model = build_model(cfg, ds, generator=gen, device="cpu",
                        conv_route=route)
    with torch.no_grad():  # non-trivial heads and norm statistics
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    rng = np.random.RandomState(0)
    pts = (rng.rand(2, 512, 3) * [1.2, 1.2, 0.6]).astype(np.float32)
    batch = {"point_clouds": pts, "point_cloud_dims_min": pts.min(1),
             "point_cloud_dims_max": pts.max(1)}
    card = Trainer(cfg, copy.deepcopy(model), ds, 1, device=cuda)
    ref = Trainer(cfg, model, ds, 1, device="cpu").eval_step(batch)
    before = nms_3d_samecls_mask.launches
    got = card.eval_step(batch)
    torch.cuda.synchronize()
    assert nms_3d_samecls_mask.launches == before + 1
    assert torch.equal(got["nms_keep"].cpu(), ref["nms_keep"])
    assert 0 < int(ref["nms_keep"].sum()) < ref["nms_keep"].numel()
    for k, v in ref.items():
        assert float((got[k].cpu().float() - v.float()).abs().max()) <= 1e-3, k


def auction_tiled(rng, g, m, repeat, slots, grid=None):
    """The training layout: row r < g * repeat copies class r % g, the
    rest 1e6 sentinels; `grid` rounds the costs to that many values (exact
    ties)."""
    base = rng.randn(g, m) * 2
    if grid:
        base = np.round(rng.rand(g, m) * (grid - 1))
    cost = np.full((slots * repeat, m), 1e6, np.float32)
    for d in range(repeat):
        cost[d * g:(d + 1) * g] = base
    return cost


AUCTION_CASES = {
    # name: (P, n, m, repeat, valid rows of each problem, ties grid)
    "capacity_published": (8, 320, 1024, 5, [15, 100, 5, 0, 320, 35, 60, 5],
                           None),
    "capacity_ties": (4, 320, 1000, 5, [100, 35, 200, 15], 3),
    "capacity_repeat2": (3, 128, 96, 2, [20, 128, 2], None),
    "plain_published_aux0": (2, 64, 4096, 1, [13, 64], None),
    "plain_ties": (4, 64, 1024, 1, [20, 7, 40, 3], 3),
    "plain_rows_past_columns": (2, 40, 20, 1, [40, 12], None),
    "plain_single_column": (2, 3, 1, 1, [3, 1], None),
    "plain_no_valid_row": (2, 10, 33, 1, [0, 0], None),
}


@pytest.mark.parametrize("name", sorted(AUCTION_CASES))
def test_auction_kernel_equals_plain(rng, cuda, name):
    """Kernel M's col4row and rounds bit for bit against the plain
    versions on the card."""
    P, n, m, repeat, nv, grid = AUCTION_CASES[name]
    if repeat > 1:
        cost = np.stack([auction_tiled(rng, k // repeat, m, repeat,
                                       n // repeat, grid) for k in nv])
    else:
        cost = (np.round(rng.rand(P, n, m) * (grid - 1)) if grid
                else rng.randn(P, n, m) * 3).astype(np.float32)
        for b, k in enumerate(nv):
            cost[b, k:] = 1e6
    c, v = t(cost, cuda), t(np.array(nv), cuda)
    got, rounds = auction_launch(c, v, repeat)
    want, want_rounds = (auction_capacity_plain(c, v, repeat) if repeat > 1
                         else auction_plain(c, v))
    assert torch.equal(got, want)
    assert torch.equal(rounds.long(), want_rounds)


@pytest.mark.parametrize("repeat", [1, 5])
def test_auction_kernel_cut_at_max_iters(rng, cuda, repeat):
    """Duplicated rows (plain) or more GT copies than genuine proposals
    (capacity) run past max_iters: rounds stop there, the rows still
    unassigned are -1, as in the plain versions."""
    if repeat == 1:
        cost = np.tile(rng.randn(12, 64).astype(np.float32) * 2, (5, 1))
        nv = [60]
    else:
        cost = np.full((320, 320), 1e6, np.float32)
        cost[:150, :64] = auction_tiled(rng, 30, 64, 5, 30)
        nv = [150]
    c, v = t(cost[None], cuda), t(np.array(nv), cuda)
    for iters in (7, 3000):
        got, rounds = auction_launch(c, v, repeat, max_iters=iters)
        want, want_rounds = (
            auction_capacity_plain(c, v, repeat, max_iters=iters)
            if repeat > 1 else auction_plain(c, v, max_iters=iters))
        assert torch.equal(got, want)
        assert torch.equal(rounds.long(), want_rounds)
    assert int(auction_launch(c, v, repeat, max_iters=7)[1][0]) == 7


def test_auction_entry_points_count_kernel_m(rng, cuda):
    cost = t(np.stack([auction_tiled(rng, 6, 128, 5, 12)]), cuda)
    nv = t(np.array([30]), cuda)
    before = auction.launches
    got = auction_capacity(cost, nv, 5)
    assert auction.launches == before + 1
    assert torch.equal(got, auction_capacity_plain(cost, nv, 5)[0])
    got = auction(cost, nv)
    assert auction.launches == before + 2
    assert torch.equal(got, auction_plain(cost, nv)[0])


def test_auction_kernel_refuses_what_it_cannot_take(cuda):
    cost = torch.rand(1, 10, 40, device=cuda)
    nv = torch.tensor([10], device=cuda)
    with pytest.raises(ValueError):  # float64
        auction_launch(cost.double(), nv)
    with pytest.raises(ValueError):  # a class's slots past a warp
        auction_launch(torch.rand(1, 64, 64, device=cuda),
                       torch.tensor([64], device=cuda), repeat=32)
    with pytest.raises(ValueError):  # fewer columns than top-k slots
        auction_launch(torch.rand(1, 10, 4, device=cuda), nv, repeat=5)
    with pytest.raises(ValueError):  # past the shared memory
        auction_launch(torch.rand(1, 2, 20000, device=cuda),
                       torch.tensor([2], device=cuda))


def test_criterion_under_the_auction_makes_no_sync(cuda):
    """A small model's train step under the auction on the card: the
    criterion runs under set_sync_debug_mode("error") without a
    synchronizing call, launching M once per shape group (2)."""
    from vdetr_tpu_torch.config import VDETRConfig
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.data.synthetic import (SyntheticDetectionDataset,
                                                collate)
    from vdetr_tpu_torch.models.vdetr import build_model
    from vdetr_tpu_torch.train.engine import INPUT_KEYS, Trainer

    cfg = VDETRConfig(
        voxel_capacity=2048, min_stage_capacity=128,
        grid_extent=(128, 128, 64), preenc_npoints=128, nqueries=64,
        dec_nlayers=3, dec_dim=32, dec_ffn_dim=32, dec_nhead=4, rpe_dim=16,
        inplanes=8, enc_dim=32, num_points=1024, voxel_size=0.05)
    ds = ScannetDatasetConfig()
    model = build_model(cfg, ds, device=cuda)
    trainer = Trainer(cfg, model, ds, steps_per_epoch=10, device=cuda)
    data = SyntheticDetectionDataset(ds, cfg.num_points, seed=0)
    b = trainer._to_device(collate([data[0], data[1]]))
    model.train()
    out = model({k: b[k] for k in INPUT_KEYS},
                generator=torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    before = auction.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, _ = trainer.criterion(out, b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert auction.launches == before + 2
    assert bool(torch.isfinite(loss))


def test_cli_at_a_tiny_config_on_the_card(tmp_path, cuda):
    """`main` on the card: one epoch with checkpoints and the final eval,
    then --test_only --auto_test on checkpoint_best with the final eval's
    mAP (--empty_pt_thre 0: the test pass's empty-box removal keeps
    every box, as the training loop's passes do)."""
    from vdetr_tpu_torch.main import main

    tiny = ["--dataset_name", "synthetic", "--voxel_capacity", "1024",
            "--min_stage_capacity", "128", "--preenc_npoints", "64",
            "--nqueries", "32", "--dec_nlayers", "2", "--dec_dim", "32",
            "--dec_ffn_dim", "32", "--rpe_dim", "8", "--inplanes", "8",
            "--enc_dim", "32", "--num_points", "512", "--repeat_num", "2",
            "--batchsize_per_gpu", "8", "--dataset_num_workers", "0"]
    ckpt = str(tmp_path / "ckpt")
    final = main(tiny + ["--max_epoch", "1", "--checkpoint_dir", ckpt],
                 device=cuda)
    again = main(["--dataset_name", "synthetic", "--test_only", "1",
                  "--auto_test", "1", "--empty_pt_thre", "0",
                  "--test_ckpt", str(tmp_path / "ckpt" / "checkpoint_best")],
                 device=cuda)
    for th in (0.25, 0.5):
        assert again[th]["mAP"] == final[th]["mAP"]
