"""The premises the port's Hopper kernels rest on, checked on the CPU.

- The sparse-conv tile GEMM (`conv_tile` in
  `vdetr_tpu_torch/csrc/sparse_conv.cuh`, kernels A and H) runs on the
  tensor cores in split TF32: each f32 operand x becomes hi = tf32(x) and
  lo = tf32(x - hi), rounded to nearest (`cvt.rna.tf32.f32`), and the
  product is hi * hi' + hi * lo' + lo * hi' with f32 sums. Emulated here
  in torch, it stays within the conv check's 1e-4 of max|ref| of the f64
  product at the published contraction depths (27 offsets x 64 and x 512
  input channels), and one TF32 pass does not: the split is needed.
- The bf16 form of that tile GEMM (`conv_tile_sm90` in
  `csrc/sparse_conv_sm90.cuh`) runs 64-wide K stages of four wgmma k16
  steps, each step's exact sum of bf16 products added to its chain and
  truncated to f32, each stage's chain started from 0 and its sum added
  to the running sum in f32. Emulated here, it stays within a hundredth
  of the conv check's 1e-4 of max|ref| of the f64 product at 27 x 64 and
  27 x 512, where one chain over the whole K does not; and a row's bits
  are the same whether the other rows of its tile are there or zero and
  whether the stages it misses are computed or skipped.
- The sparse-conv weight gradient (`dw_kernel` in `sparse_conv.cuh`,
  kernels D and I) runs the same split on the tensor cores over reduction
  depths of up to 65536 rows, each 32-row stage's products summed apart
  and the stage sums added in f32. Emulated here, it stays within a tenth
  of the dW check's 2e-5 of max|ref| at 4096 and 65536 rows, and one TF32
  pass does not meet 2e-5 itself.
- Its bf16 form (`dw_bf16_kernel` in `csrc/sparse_conv_sm90.cuh`) takes
  bf16 features against f32 dout's two bf16 halves in 64-hit stages, per
  stage the low half's chain of four truncating wgmma k16 steps, then
  the high half's, from 0, the stage partials added in f32. Emulated
  here, it stays within a tenth of 2e-5 of max|ref| of the f64 product of
  the same operands at 4096 and 65536 rows (a fifth with the split's own
  error, against the f32 dout); a stage's zero padding rows and a row split with no hit leave
  every bit unchanged (so kernels D and I, over the same lists, agree bit
  for bit); and the stem's dense packing (offset kk's 8 channels as dW
  rows kk * 8 ... kk * 8 + 7) gives each offset's sums bit for bit.
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
- The eval step's greedy same-class NMS (kernel N, `csrc/nms.cu`) works
  on positions in the order of a stable descending sort of the scores.
  Its mask kernel writes, for each box, one 64-bit word per 64-box tile
  of later positions: bit j set when the box kills box j, the overlap in
  f32 in JAX's order, each operation rounded on its own, and the
  predicate JAX's `where(same_cls, ov, 0) > thr`. Its scan walks the
  tiles in order, seeded with the invalid boxes and the positions past
  K: within a tile it resolves the 64 boxes serially against their
  words for the tile itself (a box not removed when reached is kept),
  then ORs the kept boxes' words for the later tiles into the removed
  set. Emulated here, that form keeps exactly the boxes of the literal
  argmax-and-suppress loop (the port's plain version and JAX's
  `while_loop`) on sets with forced exact score ties, pairs exactly at
  the threshold and holes in `valid`, at K a multiple of 64 and not.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetr_tpu.geometry.nms import nms_3d_samecls_mask as jax_nms
from vdetr_tpu.ops import fps as jfps
from vdetr_tpu_torch.geometry.boxes import (box_parametrization_to_corners,
                                            convert_corners_camera2lidar)
from vdetr_tpu_torch.geometry.nms import nms_3d_samecls_mask_plain
from vdetr_tpu_torch.ops import fps as tfps
from vdetr_tpu_torch.tools.nms_cases import nms_cases, nms_chain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


WG_STAGE = 64  # K of a stage of the bf16 conv body (sparse_conv_sm90.cuh)
WG_K = 16  # k of one wgmma step


def bf16_round(x):
    return x.bfloat16().float()


def wgmma_stages(a, w, live=None):
    """The bf16 conv body's sums: per 64-wide K stage (`live`: the stages
    computed, all by default) four k16 steps chained from 0, each an
    exact sum of 16 bf16 products added to the chain and truncated to f32
    (`mma`), then the stage's sum added to the running f32 sum; a (M, K)
    and w (K, N) hold bf16 values."""
    K = a.shape[1]
    stages = range(-(-K // WG_STAGE)) if live is None else live
    acc = torch.zeros(a.shape[0], w.shape[1])
    for j in stages:
        part = torch.zeros_like(acc)
        for c in range(j * WG_STAGE, min(K, (j + 1) * WG_STAGE), WG_K):
            part = mma(part, a[:, c:c + WG_K], w[c:c + WG_K].t())
        acc = acc + part
    return acc


@pytest.mark.parametrize("K", [27 * 64, 27 * 512], ids=["27x64", "27x512"])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_wgmma_stages_meet_a_hundredth_of_the_conv_tolerance(K, seed):
    """The bf16 conv body's truncating k16 chains in 64-wide stages, the
    stage sums added in f32, stay within a hundredth of chip_smoke's 1e-4
    of max|ref| of the f64 product of the same bf16 values."""
    a, w, _ = conv_operands(K, seed)
    a, w = bf16_round(a), bf16_round(w)
    err = rel_err(wgmma_stages(a, w), a.double() @ w.double())
    assert err <= 0.01 * CONV_RTOL, err


@pytest.mark.parametrize("K", [27 * 64, 27 * 512], ids=["27x64", "27x512"])
@pytest.mark.parametrize("seed", [0, 1])
def test_one_bf16_wgmma_chain_misses_a_hundredth_of_the_conv_tolerance(
        K, seed):
    """One truncating chain over the whole K, no stage sums, drifts past a
    hundredth of the tolerance: the stage sums are needed for it."""
    a, w, _ = conv_operands(K, seed)
    a, w = bf16_round(a), bf16_round(w)
    acc = torch.zeros(a.shape[0], w.shape[1])
    for c in range(0, K, WG_K):
        acc = mma(acc, a[:, c:c + WG_K], w[c:c + WG_K].t())
    err = rel_err(acc, a.double() @ w.double())
    assert 0.01 * CONV_RTOL < err <= CONV_RTOL, err


def conv_tile(C, seed, rows=64, nk=27):
    """A row tile's gathered bf16 features, (rows, nk C) with the offsets
    flattened as the body flattens them (offset-major), ~60% of (row,
    offset) pairs missing (zero), row 0 missing every third offset and
    offsets 8-15 (a whole stem stage); and bf16 weights (nk C, 64)."""
    g = torch.Generator().manual_seed(seed)
    a = torch.relu(torch.randn(rows, nk, C, generator=g))
    hit = torch.rand(rows, nk, 1, generator=g) < 0.4
    k = torch.arange(nk)
    hit[0] = ((k % 3 != 0) & ((k < 8) | (k >= 16)))[:, None]
    a = bf16_round(a * hit).reshape(rows, nk * C)
    w = bf16_round(torch.randn(nk * C, 64, generator=g) / math.sqrt(nk * C))
    return a, w


@pytest.mark.parametrize("C", [8, 64, 512], ids=["stem-8", "64", "512"])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_wgmma_row_sum_ignores_its_tile_and_skipped_stages(C, seed):
    """A row's bits from the bf16 body do not depend on the rest of its
    tile: the whole tile with every stage computed, the whole tile with the
    stages that no row hits skipped (the kernel's live list), and the row
    alone (the other rows zero) with only the stages it hits give row 0
    the same bits. A stage is 64 channels of one offset (C 64, 512) or
    eight offsets' 8 channels (the stem)."""
    a, w = conv_tile(C, seed)
    stages = -(-a.shape[1] // WG_STAGE)

    def hit_stages(x):
        return [j for j in range(stages)
                if bool(x[:, j * WG_STAGE:(j + 1) * WG_STAGE].any())]

    alone = torch.zeros_like(a)
    alone[0] = a[0]
    every = wgmma_stages(a, w)[0]
    tile_live = wgmma_stages(a, w, hit_stages(a))[0]
    row_live = wgmma_stages(alone, w, hit_stages(alone))[0]
    assert len(hit_stages(alone)) < stages
    assert torch.equal(every, tile_live) and torch.equal(every, row_live)
    assert float(every.abs().max()) > 0


DW_WG_STAGE = 64  # hits a stage of the bf16 weight gradient (dw_bf16_kernel)


def bf16_halves(d):
    """f32 dout's two bf16 halves as the kernel splits it: hi = bf16(x),
    lo = bf16(x - hi), both rounded to nearest."""
    hi = bf16_round(d)
    return hi, bf16_round(d - hi)


def wgmma_dw(a, d, skip_padding_steps=False):
    """The bf16 weight gradient's sums, a^T d: a (rows, C) bf16 values
    (the gathered feature rows, hit by hit), d (rows, Co) f32; the rows
    padded with zero rows to whole 64-hit stages; per stage the low half's
    chain, then the high half's, of four k16 steps each (`mma`: the exact
    sum of 16 products added to the chain and truncated to f32) into a
    stage partial from 0, the partials added one by one in f32.
    `skip_padding_steps`: leave out the k16 steps that hold only padding
    rows."""
    rows, C = a.shape
    pad = -rows % DW_WG_STAGE
    a = torch.nn.functional.pad(a, (0, 0, 0, pad))
    n = a.shape[0] // DW_WG_STAGE
    A = a.reshape(n, DW_WG_STAGE, C).transpose(1, 2)
    parts = torch.zeros(n, C, d.shape[1])
    for half in bf16_halves(d)[::-1]:  # lo, then hi
        H = torch.nn.functional.pad(half, (0, 0, 0, pad)).reshape(
            n, DW_WG_STAGE, d.shape[1]).transpose(1, 2)
        for c in range(0, DW_WG_STAGE, WG_K):
            step = mma(parts, A[..., c:c + WG_K], H[..., c:c + WG_K])
            if skip_padding_steps:  # stages whose step c is all padding
                real = (torch.arange(n) * DW_WG_STAGE + c) < rows
                step = torch.where(real[:, None, None], step, parts)
            parts = step
    acc = torch.zeros(C, d.shape[1])
    for p in parts:
        acc = acc + p
    return acc


@pytest.mark.parametrize("rows", [4096, 65536])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_dw_stages_meet_a_tenth_of_the_dw_tolerance(rows, seed):
    """The bf16 weight gradient's 64-hit stages (truncating k16 chains,
    low half then high, each stage from 0 and added in f32) stay within a
    tenth of chip_smoke's 2e-5 of max|ref| of the f64 product of the same
    operands, the bf16 features and dout's two bf16 halves. The split
    itself (~2^-17 of each dout) costs 1.2-1.7 tenths (the parent's
    mma.sync form split the same way): with it, within a fifth of the f64
    product with the f32 dout."""
    a, d, _ = dw_operands(rows, seed)
    a = bf16_round(a)
    got = wgmma_dw(a, d)
    hi, lo = bf16_halves(d)
    err = rel_err(got, a.double().t() @ (hi.double() + lo.double()))
    assert err <= 0.1 * DW_RTOL, err
    err = rel_err(got, a.double().t() @ d.double())
    assert err <= 0.2 * DW_RTOL, err


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_dw_padding_rows_and_empty_splits_keep_every_bit(seed):
    """A stage's zero padding rows add exact zeros to the truncating
    chains (computing the k16 steps that hold only padding gives the bits
    of leaving them out), and a row split with no hit (a zero partial)
    leaves the fixed-order sum of the splits' partials unchanged: dW's
    bits follow from the rulebook's lists and the split plan alone, which
    kernels D and I share (I = D)."""
    a, d, _ = dw_operands(1000, seed)  # 15 stages and a ragged 40 hits
    a = bf16_round(a)
    every = wgmma_dw(a, d)
    assert torch.equal(every, wgmma_dw(a, d, skip_padding_steps=True))
    splits = [wgmma_dw(a[:384], d[:384]), wgmma_dw(a[384:], d[384:])]
    empty = wgmma_dw(a[:0], d[:0])
    assert float(empty.abs().max()) == 0.0
    in_order = splits[0] + splits[1]
    assert torch.equal(in_order, splits[0] + empty + splits[1])
    assert torch.equal(in_order, (splits[0] + splits[1]) + empty)
    hi, lo = bf16_halves(d)
    ref = a.double().t() @ (hi.double() + lo.double())
    assert rel_err(in_order, ref) <= 0.1 * DW_RTOL


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_dw_dense_packing_gives_the_per_offset_sums(seed):
    """The stem's dense form: each row's 27 neighbours' 8 channels (the 3
    real ones zero-padded) packed as dW rows kk * 8 + c of one (216 -> 256
    padded, Co) product over every row, zero at a miss, gives each
    offset's (8, Co) block bit for bit as the per-offset sums over the
    same rows, and the 40 padding dW rows 0; within a tenth of 2e-5 of
    max|ref| of the f64 per-offset products of the same operands (the
    features and dout's bf16 halves)."""
    g = torch.Generator().manual_seed(seed)
    rows, Co = 1000, 64
    feats = torch.zeros(rows, 27, 8)
    feats[..., :3] = torch.relu(torch.randn(rows, 27, 3, generator=g))
    feats = bf16_round(feats * (torch.rand(rows, 27, 1, generator=g) < 0.3))
    d = torch.randn(rows, Co, generator=g)
    dense = wgmma_dw(torch.nn.functional.pad(feats.reshape(rows, 216),
                                             (0, 40)), d)
    assert float(dense[216:].abs().max()) == 0.0
    for kk in range(27):
        per = wgmma_dw(feats[:, kk], d)
        assert torch.equal(dense[8 * kk:8 * kk + 8], per), kk
    hi, lo = bf16_halves(d)
    ref = torch.einsum("rkc,ro->kco", feats.double(),
                       hi.double() + lo.double())
    assert rel_err(dense[:216].reshape(27, 8, Co), ref) <= 0.1 * DW_RTOL


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


# --------------------------------------------------------------------------
# kernel G: the windowed search of `csrc/map_kernel.cu`
# --------------------------------------------------------------------------

MAP_ROWS = 1024  # query rows per block of the map kernel


def map_levels(seed):
    """A voxel level of a small scene and the next coarser one: the
    queries of a level map (the coarse level on itself) and of a
    stride-2 map (2 * the coarse coords in the fine table)."""
    from vdetr_tpu_torch.ops.voxelize import downsample_grid, voxelize

    rng = np.random.RandomState(seed)
    pts = torch.from_numpy((rng.rand(2, 3000, 3) * [0.9, 0.7, 0.4])
                           .astype(np.float32))
    fine = voxelize(pts, pts, torch.ones(2, 3000, dtype=torch.bool),
                    voxel_size=0.02, capacity=4096, extent=(128, 128, 64))
    return fine, downsample_grid(fine, 2048)


def map_queries(kind, seed):
    """(table keys, query coords, query validity, extent) of a map."""
    fine, coarse = map_levels(seed)
    if kind == "level":
        return coarse.keys, coarse.coords, coarse.valid, coarse.extent
    return fine.keys, coarse.coords * 2, coarse.valid, fine.extent


def group_targets(q, qv, extent, g):
    """(want, lo, hi): per query row, whether its (dx, dy) group g has an
    in-range neighbour column, and the key range [lo, hi] of its z run,
    as the kernel computes them."""
    gx, gy, gz = extent
    x = q[..., 0] + g // 3 - 1
    y = q[..., 1] + g % 3 - 1
    zlo = (q[..., 2] - 1).clamp(min=0)
    zhi = (q[..., 2] + 1).clamp(max=gz - 1)
    want = qv & (x >= 0) & (x < gx) & (y >= 0) & (y < gy) & (zlo <= zhi)
    base = (x.long() * gy + y) * gz
    return want, base + zlo, base + zhi


def windowed_map(keys, q, qv, extent, window):
    """The map kernel emulated block by block: per (batch row, 1024-row
    tile, group) the window [lower_bound(least target), upper_bound(
    largest target)) of the table, staged when it holds at most `window`
    keys (else the whole table is searched), and each row's lower_bound
    and <= 3 compares run on it. Returns (map, staged blocks, blocks that
    overflowed)."""
    B, V = qv.shape
    V_in = keys.shape[1]
    nbr = torch.full((B, 27, V), V_in, dtype=torch.int32)
    staged = overflowed = 0
    sizes = []
    for b in range(B):
        kb = keys[b].long()
        for g in range(9):
            want, lo, hi = group_targets(q[b], qv[b], extent, g)
            for r0 in range(0, V, MAP_ROWS):
                rows = torch.arange(r0, min(V, r0 + MAP_ROWS))
                w = want[rows]
                if not bool(w.any()):
                    continue
                w0 = int(torch.searchsorted(kb, lo[rows][w].min()))
                w1 = int(torch.searchsorted(kb, hi[rows][w].max(),
                                            right=True))
                sizes.append(w1 - w0)
                if w1 - w0 <= window:
                    tab, off = kb[w0:w1], w0
                    staged += 1
                else:
                    tab, off = kb, 0
                    overflowed += 1
                for v in rows[w].tolist():
                    z = int(q[b, v, 2])
                    base = int(lo[v]) - max(z - 1, 0)  # key of (x, y, 0)
                    pos = int(torch.searchsorted(tab, lo[v]))
                    for s in range(3):
                        if pos + s >= len(tab) or tab[pos + s] > hi[v]:
                            break
                        slot = 3 * g + int(tab[pos + s]) - base - z + 1
                        nbr[b, slot, v] = off + pos + s
    return nbr, sizes, staged, overflowed


@pytest.mark.parametrize("kind", ["level", "stride-2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_map_queries_ascend_within_each_group(kind, seed):
    """Within each (dx, dy) group the target key runs [lo, hi] of the
    query rows that have one ascend with the row (both ends, not
    decreasing): a level's coords are in key order, 2 o keeps it, and the
    group's shift keeps it among in-range rows. So the window of a
    block's consecutive rows, which holds all their hits, spans only the
    table keys between its first and last rows' runs."""
    keys, q, qv, extent = map_queries(kind, seed)
    for b in range(q.shape[0]):
        for g in range(9):
            want, lo, hi = group_targets(q[b], qv[b], extent, g)
            assert int(want.sum()) > 100
            for ends in (lo[want], hi[want]):
                assert bool((ends[1:] >= ends[:-1]).all()), (b, g)


@pytest.mark.parametrize("kind", ["level", "stride-2"])
def test_windowed_search_gives_neighbour_map(kind):
    """The kernel's windowed search, emulated, equals `neighbour_map` bit
    for bit, with the kernel's staging size (8192 keys: every window
    fits) and with one of the median window's size, so that about half
    of the blocks overflow to the whole table."""
    from vdetr_tpu_torch.ops.map_kernel import neighbour_map

    keys, q, qv, extent = map_queries(kind, 0)
    ref = neighbour_map(keys, q, qv, extent)
    got, sizes, staged, overflowed = windowed_map(keys, q, qv, extent, 8192)
    assert torch.equal(got, ref)
    assert staged == len(sizes) and overflowed == 0
    window = int(np.median(sizes))
    got, _, staged, overflowed = windowed_map(keys, q, qv, extent, window)
    assert torch.equal(got, ref)
    assert staged > 0 and overflowed > 0


# --------------------------------------------------------------------------
# probe J2: the corner-first split-TF32 contraction of `csrc/dot_micro.cu`
# --------------------------------------------------------------------------

def corner_first_split_tf32(T, P):
    """T summed over the corners in f32 in corner order, then Tsum^T P on
    the emulated tensor cores in split TF32: each chunk's k8 MMAs (the
    kernel's chunk depth, `kernel_chunk`) chained from 0, each truncated
    to f32, the chunk's sum added in f32."""
    from vdetr_tpu_torch.tools.dot_micro import kernel_chunk

    chunk = kernel_chunk(T.shape[0])
    s = T[0].clone()
    for c in range(1, T.shape[0]):
        s = s + T[c]
    a, b = s.t(), P.t()  # (M, K), (E, K)
    K = a.shape[1]
    pad = -K % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, pad))
    acc = torch.zeros(a.shape[0], b.shape[0])
    for k0 in range(0, K, chunk):
        part = torch.zeros_like(acc)
        for k in range(k0, min(K, k0 + chunk), 8):
            part = split_mma(part, a[:, k:k + 8], b[:, k:k + 8], False)
        acc = acc + part
    return acc


@pytest.mark.parametrize("K,M,nc", [(100, 40, 8), (128, 40, 8),
                                    (128, 128, 8), (800, 40, 1)],
                         ids=["K100-M40", "K128-M40", "K128-M128",
                              "K800-M40-x1"])
def test_corner_first_split_tf32_meets_the_probe_tolerance(K, M, nc):
    """The probe's five variants (the two at E 4096 and 8192 share K and
    M; E cut to 64 columns here): the kernel's arithmetic, emulated, stays
    within the probe check's elementwise `rounding_rtol` of the f64
    result, on the tool's positive rand inputs."""
    from vdetr_tpu_torch.tools.dot_micro import rounding_rtol

    g = torch.Generator().manual_seed(K + M + nc)
    T = torch.rand(nc, K, M, generator=g)
    P = torch.rand(K, 64, generator=g)
    ref = torch.einsum("ckm,ke->me", T.double(), P.double())
    got = corner_first_split_tf32(T, P)
    rel = float(((got.double() - ref) / ref).abs().max())
    assert rel <= rounding_rtol(T), rel


# --------------------------------------------------------------------------
# kernel F: dTables in fixed point, summed in slice order
# --------------------------------------------------------------------------

TABLE_QUERIES = 32  # queries per table block


def fixed_point_tables(ds, taps, n, keys_per_block):
    """The table kernel and `rpe_table_sum`, emulated: every weighted ds
    of the launch rounded to an integer multiple of 2^-k (k = 30 - e for
    the largest |ds| < 2^e), summed exactly in int64 per block (32
    queries, one corner, a share of the keys), each block's table rounded
    once to f32, then the slices (batch row, query tile, key share) added
    in order in f32. `taps[c]`: corner c's trilinear taps, (cell, weight)
    each (B, nQ, nK). Returns (dtables, largest |term| in units 2^-k,
    largest |block word| in those units)."""
    B, H, nQ, nK = ds.shape
    _, e = math.frexp(float(ds.abs().max()))
    k = min(30 - e, 126)
    slices, top_term, top_word = [], 0, 0
    for b in range(B):
        for q0 in range(0, nQ, TABLE_QUERIES):
            for k0 in range(0, nK, keys_per_block):
                sl = torch.zeros(8, n ** 3, H)
                block = (slice(b, b + 1), slice(q0, q0 + TABLE_QUERIES),
                         slice(k0, k0 + keys_per_block))
                d = ds[b, :, block[1], block[2]]
                d = d.permute(1, 2, 0).reshape(-1, H)
                for c in range(8):
                    acc = torch.zeros(n ** 3, H, dtype=torch.int64)
                    for cell, w in taps[c]:
                        x = torch.round((d * w[block].reshape(-1, 1))
                                        * 2.0 ** k)
                        top_term = max(top_term, float(x.abs().max()))
                        acc.index_add_(0, cell[block].reshape(-1),
                                       x.long())
                    top_word = max(top_word, int(acc.abs().max()))
                    sl[c] = acc.float() * 2.0 ** -k
                slices.append(sl)
    out = slices[0]
    for sl in slices[1:]:
        out = out + sl
    return out.reshape(8, n, n, n, H), top_term, top_word


def test_fixed_point_table_sums_meet_the_bwd_tolerance():
    """At the decoder's key count and head shape (nK 4096, 4 heads of 64,
    n 10) and the table kernel's largest block at the published shape
    (32 queries x 4096 keys, B = 4), on ds from the plain forward and
    backward with the decoder's box corners: the fixed-point sums in
    slice order stay within a tenth of F's tolerance (2e-5 of max(1,
    max|ref|)) of the f64 sums, closer than the plain f32 index_add_;
    every term stays below 2^30 and every block word far inside int64."""
    from vdetr_tpu_torch.ops.rpe_attention import (
        _corner_taps, rpe_cross_attention_bwd_plain, rpe_cross_attention_plain)

    B, nQ, nK, H, hd, n = 1, 64, 4096, 4, 64, 10
    kw = dict(log_scale=512.0, max_value=4.0)
    g = torch.Generator().manual_seed(5)
    q = torch.randn(B, nQ, H, hd, generator=g) * hd ** -0.5
    kv = [torch.randn(B, nK, hd, generator=g) for _ in range(2)]
    corners = box_corners(torch.zeros(nQ), seed=6)[None].contiguous()
    key_xyz = torch.rand(B, nK, 3, generator=g) * torch.tensor([6.0, 6.0,
                                                                2.5])
    tables = torch.randn(8, n, n, n, H, generator=g)
    valid = torch.rand(B, nK, generator=g) > 0.1
    out, lse, logits = rpe_cross_attention_plain(
        q, kv[0], kv[1], corners, None, key_xyz, tables, valid,
        return_stats=True, **kw)
    dout = torch.randn(out.shape, generator=g)
    _, ref, ds, _ = rpe_cross_attention_bwd_plain(
        kv[0], kv[1], corners, None, key_xyz, valid, out, dout, logits, lse,
        n, **kw)
    # each corner's taps once, for the emulated blocks and the f64 sums
    taps = [_corner_taps(corners, None, key_xyz, c, False, kw["log_scale"],
                         kw["max_value"], n) for c in range(8)]
    got, top_term, top_word = fixed_point_tables(ds, taps, n, nK)
    exact = torch.zeros(8, n ** 3, H, dtype=torch.float64)
    d = ds[0].permute(1, 2, 0).reshape(-1, H).double()
    for c in range(8):
        for cell, w in taps[c]:
            exact[c].index_add_(0, cell.reshape(-1), d * w.reshape(-1, 1))
    exact = exact.reshape(got.shape)
    tol = BWD_RTOL * max(1.0, float(exact.abs().max()))
    err = float((got.double() - exact).abs().max())
    plain_err = float((ref.double() - exact).abs().max())
    assert err <= 0.1 * tol, (err, tol)
    assert err <= max(plain_err, 1e-3 * tol), (err, plain_err)
    assert top_term < 2 ** 30
    assert top_word < 2 ** 62


def test_fixed_point_term_rounds_without_a_conversion():
    """`add_fixed` of the table kernel rounds a scaled term s (|s| < 2^30)
    to the integer x = hi 2^15 + lo, hi = round(s 2^-15) and lo = round(s
    - hi 2^15), both rounded to nearest even by float adds: x is round(s)
    and |x| < 2^31. Exact in float64 here (s has 24 bits)."""
    rng = np.random.RandomState(7)
    s = np.concatenate([
        (rng.rand(20000) * 2 - 1) * 2.0 ** rng.randint(-20, 30, 20000),
        np.arange(-40, 41) * 0.5,  # halves: ties to even
        np.arange(-8, 9) * 2.0 ** 14 + 2.0 ** 13,  # ties in the high part
        [2.0 ** 30 - 64, -(2.0 ** 30 - 64)]]).astype(np.float32)
    s64 = s.astype(np.float64)
    hi = np.rint(s64 / 2 ** 15)
    lo = np.rint(s64 - hi * 2 ** 15)
    x = hi * 2 ** 15 + lo
    np.testing.assert_array_equal(x, np.rint(s64))
    assert np.abs(hi).max() <= 2 ** 15 and np.abs(lo).max() <= 2 ** 14
    assert np.abs(x).max() < 2 ** 31


def test_low_high_halves_with_carry_sum_exactly():
    """`add_fixed`'s 64-bit add from two 32-bit atomics, emulated in three
    orders of arrival: each signed term (|x| < 2^31) is added to the low
    half with wrap-around, and its sign extension plus the carry out of
    the low half to the high half; the halves then hold the exact int64
    sum, whatever the order (the words are sums of commuting integer
    adds)."""
    rng = np.random.RandomState(7)
    terms = (rng.standard_cauchy(20000) * 2 ** 22).clip(-2 ** 30, 2 ** 30)
    terms = terms.astype(np.int64)
    terms[:5000] = np.abs(terms[:5000])  # long positive runs: many carries
    want = int(terms.sum())
    for order in (np.arange(len(terms)), rng.permutation(len(terms)),
                  rng.permutation(len(terms))):
        lo, hi, high_adds = 0, 0, 0
        for x in terms[order].tolist():
            old = lo
            lo = (old + (x & 0xFFFFFFFF)) & 0xFFFFFFFF
            c = (-1 if x < 0 else 0) + (1 if lo < old else 0)
            high_adds += c != 0
            hi += c
        total = (hi & 0xFFFFFFFF) << 32 | lo
        total = total - (1 << 64) if total >= 1 << 63 else total
        assert total == want
        assert 0 < high_adds < len(terms)


NMS_ROUNDS = 4  # csrc/nms.cu ROUNDS: warp rounds before a tile's walk


def nms_scan(aabbs, scores, classes, valid, thr, old_type,
             rounds=NMS_ROUNDS):
    """Kernel N on one scene in numpy float32 (one rounding per
    operation, no fused multiply-add): the mask kernel's words, then the
    scan kernel's pass over them in 64-box tiles, each tile resolved by
    up to `rounds` rounds of kept = alive & ~(OR of the kept rows'
    diagonal words) from kept = alive, or, where no round came back
    unchanged, walked in order. Returns the keep mask, the words (mask
    (K, W) and seed (W,), uint64) and the number of tiles walked."""
    K = len(scores)
    W = -(-K // 64)
    order = torch.sort(torch.from_numpy(scores), descending=True,
                       stable=True).indices.numpy()
    x1, y1, z1, x2, y2, z2 = aabbs[order].T
    cls = classes[order]
    area = ((x2 - x1) * (y2 - y1)) * (z2 - z1)
    zero = np.float32(0)

    def span(lo, hi):  # row i (the kept box), column j (the box tested)
        return np.maximum(np.minimum(hi[:, None], hi[None])
                          - np.maximum(lo[:, None], lo[None]), zero)

    inter = (span(x1, x2) * span(y1, y2)) * span(z1, z2)
    denom = (np.broadcast_to(area[None], inter.shape) if old_type
             else (area[:, None] + area[None]) - inter)
    ov = inter / np.maximum(denom, np.float32(1e-12))
    kill = np.where(cls[:, None] == cls[None], ov, zero) > thr
    kill &= np.arange(K)[None] > np.arange(K)[:, None]  # later positions
    bits = np.zeros((K, W * 64), bool)
    bits[:, :K] = kill
    mask = np.packbits(bits, axis=1, bitorder="little").view("<u8")
    gone = np.ones(W * 64, bool)
    gone[:K] = ~valid[order]
    seed = np.packbits(gone, bitorder="little").view("<u8")

    removed = [int(w) for w in seed]
    kept_pos, walked = [], 0
    for t in range(W):
        diag = [int(mask[p, t]) for p in range(t * 64, min(t * 64 + 64, K))]
        alive = ~removed[t] & (2 ** 64 - 1)
        bits, settled = alive, False
        for _ in range(rounds):
            killed = 0
            for i, w in enumerate(diag):
                if bits >> i & 1:
                    killed |= w
            settled, bits = alive & ~killed == bits, alive & ~killed
            if settled:
                break
        if not settled:
            walked += 1
            gone, bits = removed[t], 0
            for i, w in enumerate(diag):
                if not gone >> i & 1:
                    bits |= 1 << i
                    gone |= w
        kept = [t * 64 + i for i in range(64) if bits >> i & 1]
        kept_pos += kept
        if kept and t + 1 < W:
            later = np.bitwise_or.reduce(mask[kept, t + 1:], axis=0)
            for u, w in enumerate(later, t + 1):
                removed[u] |= int(w)
    keep = np.zeros(K, bool)
    keep[order[kept_pos]] = True
    return keep, mask, seed, walked


NMS_SCENES = {64: 2, 1024: 2, 1000: 1, 4100: 1}


@pytest.mark.parametrize("old_type", [False, True], ids=["iou", "old_type"])
@pytest.mark.parametrize("K", list(NMS_SCENES))
def test_nms_sorted_scan_equals_the_argmax_loop(K, old_type):
    """Exact, keep mask for keep mask: the bitmask form against the
    literal loop of the port (torch) and of JAX, on `tools/nms_cases.py`'s
    sets (exact ties in half the scores, a pair at overlap exactly 0.25 in
    every eight boxes, one box in ten not valid), two scenes at K 64 and
    1024, one at K 1000 and 4100 (a last tile of 40 and of 4 boxes), the
    tiles resolved as the kernel resolves them and, again, all walked in
    order and all by rounds alone. No word has a bit at or before its
    own row's position, and the seed marks every position past K."""
    rng = np.random.RandomState(11)
    B = NMS_SCENES[K]
    aabbs, scores, classes, valid = nms_cases(rng, B, K)
    assert (np.unique(scores, return_counts=True)[1] > 1).any()
    loop = nms_3d_samecls_mask_plain(
        torch.from_numpy(aabbs), torch.from_numpy(scores),
        torch.from_numpy(classes), torch.from_numpy(valid), 0.25,
        old_type).numpy()
    jloop = np.asarray(jax.vmap(lambda a, s, c, v: jax_nms(
        a, s, c, v, 0.25, old_type))(aabbs, scores, classes, valid))
    for b in range(B):
        args = (aabbs[b], scores[b], classes[b], valid[b], np.float32(0.25),
                old_type)
        scan, mask, seed, walked = nms_scan(*args)
        np.testing.assert_array_equal(scan, loop[b])
        np.testing.assert_array_equal(scan, jloop[b])
        # every tile walked in order, and every tile by rounds alone
        for rounds in (0, 64):
            again, _, _, n = nms_scan(*args, rounds=rounds)
            np.testing.assert_array_equal(again, scan)
            assert n == (len(seed) if rounds == 0 else 0)
        # the threshold pairs: (2, 1, 1) s against (3, 1, 1) s, overlap
        # exactly 1/4 in f32, are both kept where both are alive first
        assert 0 < scan.sum() < valid[b].sum()
        bits = np.unpackbits(mask.view(np.uint8), axis=1,
                             bitorder="little")[:, :K]
        assert not np.tril(bits).any()
        tail = np.unpackbits(seed.view(np.uint8), bitorder="little")[K:]
        assert tail.all()


@pytest.mark.parametrize("old_type", [False, True], ids=["iou", "old_type"])
def test_nms_scan_walks_the_tiles_the_rounds_do_not_settle(old_type):
    """A chain of boxes, each killing the next (`tools/nms_cases.py`'s
    `nms_chain`, K 200 in a random order): each tile's fate chain is as
    long as the tile (64 boxes, the last 8), more than the kernel's 4
    rounds settle, so it walks every tile in order; the keep mask still
    equals the loop's (torch and JAX), every other box of the chain."""
    aabbs, scores, classes, valid = nms_chain(np.random.RandomState(5), 1,
                                              200)
    loop = nms_3d_samecls_mask_plain(
        torch.from_numpy(aabbs), torch.from_numpy(scores),
        torch.from_numpy(classes), torch.from_numpy(valid), 0.25,
        old_type).numpy()[0]
    jloop = np.asarray(jax_nms(aabbs[0], scores[0], classes[0], valid[0],
                               0.25, old_type))
    scan, _, _, walked = nms_scan(aabbs[0], scores[0], classes[0],
                                  valid[0], np.float32(0.25), old_type)
    assert walked == 4  # every tile: the last one's chain of 8 too
    np.testing.assert_array_equal(scan, loop)
    np.testing.assert_array_equal(scan, jloop)
    rank = np.argsort(-scores[0], kind="stable")
    np.testing.assert_array_equal(scan[rank], np.arange(200) % 2 == 0)
