"""The premises the port's Hopper kernels rest on, checked on the CPU.

- The sparse-conv tile GEMM (`conv_tile` in
  `vdetr_tpu_torch/csrc/sparse_conv.cuh`, kernels A and H) runs on the
  tensor cores in split TF32: each f32 operand x becomes hi = tf32(x) and
  lo = tf32(x - hi), rounded to nearest (`cvt.rna.tf32.f32`), and the
  product is hi * hi' + hi * lo' + lo * hi' with f32 sums. Emulated here
  in torch, it stays within the conv check's 1e-4 of max|ref| of the f64
  product at the published contraction depths (27 offsets x 64 and x 512
  input channels), and one TF32 pass does not: the split is needed.
- The sparse-conv weight gradient (`dw_kernel` in `sparse_conv.cuh`,
  kernels D and I) runs the same split on the tensor cores over reduction
  depths of up to 65536 rows, each 32-row stage's products summed apart
  and the stage sums added in f32. Emulated here, it stays within a tenth
  of the dW check's 2e-5 of max|ref| at 4096 and 65536 rows, and one TF32
  pass does not meet 2e-5 itself.
- The flash-RPE backward's table kernel (kernel F in
  `csrc/rpe_attention_bwd.cu`) quantizes x and y once for corners i and
  i + 4 when their x and y agree bit for bit. On the main path the
  corners come from `box_parametrization_to_corners` and
  `convert_corners_camera2lidar`, where those corners differ in z alone,
  rotated or not, so the shared quantize is the path the model takes.
- The flash-RPE backward's pair kernel (kernel F's `rpe_pair_bwd_kernel`)
  multiplies dp = dO V^T and dQ = ds K on the tensor cores in split TF32,
  every m16n8k8 MMA accumulating with truncation (emulated: the exact sum
  rounded toward zero to f32), dp chained from 0 over the head width,
  dQ chained from 0 over each 32-key tile and the tiles' and key shares'
  sums added in f32, ds formed in f32 from dp as the kernel forms it.
  Emulated here at hd 64 up to nK 4096, ds and dq stay within a tenth of
  F's card-test tolerance (2e-5 of max(1, max|ref|)) of the f64 result,
  and one TF32 pass misses it. The kernel feeds dp's accumulator
  fragment to dQ as its A fragment unchanged, column t standing for key
  2t and column t + 4 for key 2t + 1, with K's rows 2t and 2t + 1 as the
  B fragment: the fragment layouts of PTX, emulated lane by lane, give
  ds K.
- Furthest-point sampling (kernel B, `csrc/fps.cu`) picks each step's
  point by a packed u32 key (0 for a point never picked, else the
  running distance's float bits + 1) reduced in two levels: each warp's
  largest key and, among its lanes holding it, the smallest index, into
  one slot per warp; then the same over the slots. Emulated here in
  torch, with the kernel's layout of points over threads, it picks
  `fps_jax`'s indices on lattice ties, on an all-zero row and on a row
  with fewer valid points than npoint.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetr_tpu.ops import fps as jfps
from vdetr_tpu_torch.geometry.boxes import (box_parametrization_to_corners,
                                            convert_corners_camera2lidar)
from vdetr_tpu_torch.ops import fps as tfps

CONV_RTOL = 1e-4  # chip_smoke.py's conv tolerance: 1e-4 of max|ref|


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as `cvt.rna.tf32.f32` does; the low 13 bits are 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def conv_operands(K, seed):
    """256 gathered rows of ReLU'd features against (K, 64) weights scaled
    by 1/sqrt(K), as a published conv sees them."""
    g = torch.Generator().manual_seed(seed)
    a = torch.relu(torch.randn(256, K, generator=g))
    w = torch.randn(K, 64, generator=g) / math.sqrt(K)
    return a, w, a.double() @ w.double()


def rel_err(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 3 * 2.0 ** -11), 3.0])
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                         -(1.0 + 2.0 ** -9), 3.0])
    assert torch.equal(tf32(x), want)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert int((tf32(y).view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((tf32(y) - y) / y).abs().max()) <= 2.0 ** -11


@pytest.mark.parametrize("K", [27 * 64, 27 * 512], ids=["27x64", "27x512"])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_meets_the_conv_tolerance(K, seed):
    a, w, ref = conv_operands(K, seed)
    ah, bh = tf32(a), tf32(w)
    al, bl = tf32(a - ah), tf32(w - bh)
    split = al @ bh + ah @ bl + ah @ bh
    err = rel_err(split, ref)
    assert err <= 0.05 * CONV_RTOL, err
    # within a small factor of a plain f32 product's own error
    assert err <= 4 * max(rel_err(a @ w, ref), 2.0 ** -24 * math.sqrt(K))


@pytest.mark.parametrize("K", [27 * 64, 27 * 512], ids=["27x64", "27x512"])
@pytest.mark.parametrize("seed", [0, 1])
def test_one_tf32_pass_misses_the_conv_tolerance(K, seed):
    a, w, ref = conv_operands(K, seed)
    assert rel_err(tf32(a) @ tf32(w), ref) > CONV_RTOL


DW_RTOL = 2e-5  # chip_smoke.py's weight-gradient tolerance
DW_STAGE = 32  # rows per stage of dw_kernel


def dw_operands(rows, seed):
    """ReLU'd features of 16 input channels and a signed gradient of 16
    output channels over `rows` rows, and their f64 product dW = a^T d."""
    g = torch.Generator().manual_seed(seed)
    a = torch.relu(torch.randn(rows, 16, generator=g))
    d = torch.randn(rows, 16, generator=g)
    return a, d, a.double().t() @ d.double()


def staged_dw(a, d, product):
    """sum over 32-row stages of product(A_s, D_s) (each stage's (16, 16)
    f32 sum), the stage sums added one by one in f32."""
    n = a.shape[0] // DW_STAGE
    parts = product(a.reshape(n, DW_STAGE, -1).transpose(1, 2),
                    d.reshape(n, DW_STAGE, -1))
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc = acc + p
    return acc


def split_product(a, d):
    ah, dh = tf32(a), tf32(d)
    al, dl = tf32(a - ah), tf32(d - dh)
    return al @ dh + ah @ dl + ah @ dh


@pytest.mark.parametrize("rows", [4096, 65536])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_dw_in_stages_meets_a_tenth_of_the_dw_tolerance(rows,
                                                                   seed):
    a, d, ref = dw_operands(rows, seed)
    err = rel_err(staged_dw(a, d, split_product), ref)
    assert err <= 0.1 * DW_RTOL, err


@pytest.mark.parametrize("rows", [4096, 65536])
@pytest.mark.parametrize("seed", [0, 1])
def test_one_tf32_pass_dw_misses_the_dw_tolerance(rows, seed):
    a, d, ref = dw_operands(rows, seed)
    err = rel_err(staged_dw(a, d, lambda x, y: tf32(x) @ tf32(y)), ref)
    assert err > DW_RTOL, err


BWD_RTOL = 2e-5  # F's card-test tolerance: 2e-5 of max(1, max|ref|)
PAIR_TILE = 32  # keys per tile of the pair kernel
PAIR_SHARE = 704  # keys per block at the published shape (6 shares)


def rz_f32(x):
    """float64 -> float32 rounded toward zero."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def mma(acc, a, b):
    """One m16n8k8 step: acc + a b^T with the 8 products summed exactly
    and the result truncated to f32; a (.., M, 8), b (.., N, 8)."""
    return rz_f32(acc.double() + a.double() @ b.double().transpose(-1, -2))


def split_mma(acc, a, b, one_pass):
    """acc + a b^T in split TF32 (lo hi, hi lo, then hi hi, each an MMA),
    or in one TF32 pass."""
    if one_pass:
        return mma(acc, tf32(a), tf32(b))
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return mma(mma(mma(acc, al, bh), ah, bl), ah, bh)


def pair_dp(dout, v, one_pass):
    """dp = dO V^T (rows, keys) chained from 0 over the head width."""
    acc = torch.zeros(dout.shape[0], v.shape[0])
    for c in range(0, dout.shape[1], 8):
        acc = split_mma(acc, dout[:, c:c + 8], v[:, c:c + 8], one_pass)
    return acc


def pair_dq(ds, k, one_pass):
    """dQ = ds K: each 32-key tile chained from 0, its sum added to its
    key share's in f32, the shares added in order in f32."""
    nK = ds.shape[1]
    shares = []
    for s0 in range(0, nK, PAIR_SHARE):
        acc = torch.zeros(ds.shape[0], k.shape[1])
        for t0 in range(s0, min(nK, s0 + PAIR_SHARE), PAIR_TILE):
            part = torch.zeros_like(acc)
            for c in range(t0, min(nK, t0 + PAIR_TILE), 8):
                part = split_mma(part, ds[:, c:c + 8], k[c:c + 8].t(),
                                 one_pass)
            acc = acc + part
        shares.append(acc)
    dq = shares[0]
    for part in shares[1:]:
        dq = dq + part
    return dq


def pair_errors(nK, logit_scale, one_pass, rows=256, hd=64, seed=0):
    """(ds error, dq error) of the emulated pair kernel against float64,
    each over its tolerance, on decoder-like operands: unit-normal dO, K
    and V, an output of a tenth of V's variance, logits of the given
    spread, a tenth of the keys masked and dropout 0.1."""
    g = torch.Generator().manual_seed(seed)
    dout = torch.randn(rows, hd, generator=g)
    out = torch.randn(rows, hd, generator=g) * 0.3
    k = torch.randn(nK, hd, generator=g)
    v = torch.randn(nK, hd, generator=g)
    logits = torch.randn(rows, nK, generator=g) * logit_scale
    valid = torch.rand(nK, generator=g) > 0.1
    keep = torch.where(torch.rand(rows, nK, generator=g) > 0.1, 1 / 0.9,
                       0.0).float()
    lse = torch.logsumexp(torch.where(valid, logits.double(), -1e30), -1,
                          keepdim=True)
    e64 = torch.where(valid, torch.exp(logits.double() - lse), 0.0)
    D64 = (dout.double() * out.double()).sum(-1, keepdim=True)
    ds64 = torch.where(valid, e64 * (keep.double() * (dout.double()
                                                      @ v.double().t())
                                     - D64), 0.0)
    dq64 = ds64 @ k.double()
    e = torch.where(valid, torch.exp(logits - lse.float()), 0.0)
    D = (dout * out).sum(-1, keepdim=True)
    ds = torch.where(valid, e * (keep * pair_dp(dout, v, one_pass) - D), 0.0)
    dq = pair_dq(ds, k, one_pass)
    return tuple(float((x.double() - ref).abs().max())
                 / (BWD_RTOL * max(1.0, float(ref.abs().max())))
                 for x, ref in ((ds, ds64), (dq, dq64)))


PAIR_CASES = [(64, 1.0), (4096, 1.0), (4096, 6.0)]
PAIR_IDS = ["64-keys", "4096-keys", "4096-keys-peaked"]


@pytest.mark.parametrize("nK,logit_scale", PAIR_CASES, ids=PAIR_IDS)
def test_split_tf32_pair_products_meet_a_tenth_of_the_bwd_tolerance(
        nK, logit_scale):
    ds_err, dq_err = pair_errors(nK, logit_scale, one_pass=False)
    assert ds_err <= 0.1 and dq_err <= 0.1, (ds_err, dq_err)


@pytest.mark.parametrize("nK,logit_scale", PAIR_CASES, ids=PAIR_IDS)
def test_one_tf32_pass_pair_products_miss_the_bwd_tolerance(nK,
                                                            logit_scale):
    ds_err, dq_err = pair_errors(nK, logit_scale, one_pass=True)
    assert ds_err > 1 and dq_err > 1, (ds_err, dq_err)


def mma_fragments(a_frag, b_frag):
    """m16n8k8 on per-lane fragments as PTX lays them out for TF32: lane
    4g + t holds A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) and B
    (t, g), (t + 4, g); returns the 16 x 8 product."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a_frag[lane]
        B[t, g], B[t + 4, g] = b_frag[lane]
    return A @ B


def test_dp_accumulator_fragment_is_dq_a_fragment_with_k_rows_2t():
    """dp's accumulator fragment (lane 4g + t: row g keys 2t, 2t + 1, row
    g + 8 the same keys) handed to dQ's MMA as the A fragment (c0, c2, c1,
    c3), with K's rows 2t and 2t + 1 as the B fragment, gives ds K."""
    rng = np.random.RandomState(7)
    ds = rng.randint(-8, 9, (16, 8)).astype(np.float64)  # 16 rows, 8 keys
    k = rng.randint(-8, 9, (8, 8)).astype(np.float64)  # 8 keys, 8 dims
    a_frag, b_frag = [], []
    for lane in range(32):
        g, t = divmod(lane, 4)
        c = (ds[g, 2 * t], ds[g, 2 * t + 1], ds[g + 8, 2 * t],
             ds[g + 8, 2 * t + 1])
        a_frag.append((c[0], c[2], c[1], c[3]))
        b_frag.append((k[2 * t, g], k[2 * t + 1, g]))
    np.testing.assert_array_equal(mma_fragments(a_frag, b_frag), ds @ k)


def box_corners(angles, seed):
    rng = np.random.RandomState(seed)
    n = angles.shape[0]
    centers = torch.from_numpy((rng.rand(n, 3) * [6.0, 6.0, 2.0])
                               .astype(np.float32))
    sizes = torch.from_numpy((rng.rand(n, 3) * 1.5 + 0.1).astype(np.float32))
    return convert_corners_camera2lidar(
        box_parametrization_to_corners(centers, sizes, angles))


@pytest.mark.parametrize("kind", ["axis-aligned", "rotated", "quarter-turns",
                                  "negative"])
def test_box_corners_i_and_i4_share_world_x_and_y(kind):
    n = 4096
    rng = np.random.RandomState(3)
    angles = {
        "axis-aligned": np.zeros(n),
        "rotated": (rng.rand(n) - 0.5) * 6.2,
        "quarter-turns": rng.randint(-4, 5, n) * (np.pi / 2),
        "negative": -rng.rand(n) * np.pi,
    }[kind]
    c = box_corners(torch.from_numpy(angles.astype(np.float32)), seed=4)
    low, high = c[:, :4], c[:, 4:]
    # bit for bit, as the kernel compares them
    assert torch.equal(low[..., :2].contiguous().view(torch.int32),
                       high[..., :2].contiguous().view(torch.int32))
    # and the z of a box's top and bottom corners differ
    assert bool((low[..., 2] != high[..., 2]).all())


NONE = 2 ** 32 - 1  # an index that loses every min (the kernel's 0xffffffff)


def first_of_max(key, idx, dim):
    """The largest key along `dim` and, among the entries holding it, the
    smallest index: redux.sync max, then redux.sync min."""
    top = key.max(dim).values
    held = key == top.unsqueeze(dim)
    return top, torch.where(held, idx, NONE).min(dim).values


def packed_key_fps(xyz, npoint, cluster, threads):
    """Kernel B's selection emulated: point g = k * cluster * threads +
    rank * threads + tid, padded to the plan's tier; per thread the first
    slot of the largest key, per warp the two redux into its slot, then
    each lane's slots (lane, lane + 32, ...) and the two redux over the
    lanes; the winner's coordinates read back from the slot its index
    names."""
    B, N, _ = xyz.shape
    span = cluster * threads
    ppt = tfps.fps_plan(N, cluster, threads)[0] or -(-N // span)
    cap = ppt * span
    x = torch.cat([xyz, xyz.new_zeros(B, cap - N, 3)], 1)
    g = torch.arange(cap, dtype=torch.int64)
    never = (tfps._sq_norm(x[..., 0], x[..., 1], x[..., 2]) <= 1e-3) | (
        g >= N)
    dist = torch.where(never, -1.0, 1e10).float()
    warps = threads // 32
    g4 = g.view(ppt, cluster, threads).expand(B, -1, -1, -1)
    cur = x[:, 0]
    out = torch.zeros(B, npoint, dtype=torch.int64)
    for j in range(1, npoint):
        d = x - cur[:, None]
        dist = torch.minimum(dist, tfps._sq_norm(d[..., 0], d[..., 1],
                                                 d[..., 2]))
        bits = dist.view(torch.int32).long()
        key = torch.where(bits < 0, 0, bits + 1).view(B, ppt, cluster,
                                                     threads)
        tkey, tidx = first_of_max(key, g4, 1)              # per thread
        wkey, widx = first_of_max(tkey.view(B, cluster, warps, 32),
                                  tidx.view(B, cluster, warps, 32), -1)
        slots = cluster * warps                            # slot r * W + w
        lkey, lidx = first_of_max(wkey.view(B, slots // 32, 32),
                                  widx.view(B, slots // 32, 32), 1)
        _, cidx = first_of_max(lkey, lidx, -1)
        slot = (cidx // threads) % cluster * warps + cidx % threads // 32
        assert torch.equal(widx.view(B, slots).gather(1, slot[:, None])[:, 0],
                           cidx)
        cur = x[torch.arange(B), cidx]
        out[:, j] = cidx
    return out


def fps_rows(kind, seed):
    rng = np.random.RandomState(seed)
    xyz = (rng.randint(0, 30, size=(2, 3000, 3)) * 4 + 32).astype(
        np.float32) * np.float32(0.01)
    if kind == "zero-row":
        xyz[1] = 0.0
    elif kind == "fewer-valid":
        xyz[:, 40:] = 0.0  # 40 valid points, npoint 128
    return xyz.astype(np.float32)


@pytest.mark.parametrize("form", [(tfps.CLUSTER, tfps.THREADS), (8, 128)],
                         ids=["wrapper-form", "8x128"])
@pytest.mark.parametrize("kind", ["lattice-ties", "zero-row",
                                  "fewer-valid"])
def test_packed_key_two_level_reduction_picks_fps_jax(kind, form):
    xyz = fps_rows(kind, seed=5)
    want = np.asarray(jfps.fps_jax(jnp.asarray(xyz), 128))
    got = packed_key_fps(torch.from_numpy(xyz), 128, *form)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "zero-row":
        assert not want[1].any()
