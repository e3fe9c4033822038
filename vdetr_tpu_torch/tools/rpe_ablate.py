"""Stage ablation of the vertex-RPE cross-attention (kernel C) on the card.

    python -m vdetr_tpu_torch.tools.rpe_ablate [--device cuda|cpu]

Counterpart of the JAX package's TPU probe `tools/rpe_ablate.py`: the
attention of the published decoder's shapes (B 1, nQ 1024, nK 4096, H 4,
hd 64, n 10, `log_scale` 512, `max_value` 4) with the RPE bias built up in
seven cumulative levels, each a pairwise function of (query, key):

    logit[h, q, k] = q[q, h] . k[k] + bias_L[h, q, k]; softmax over k;
    out[q, h] = sum_k p * v[k]

with no key mask, scale or rotation. With d = corner_c - key per axis,
i = the continuous table index of d (the JAX `_quantize`) and hat_j(x) =
max(1 - |j - x|, 0), summed over the 8 corners c:

    0  no bias (flash attention alone)
    1  dx + dy + dz
    2  i(dx) + i(dy) + i(dz)
    3  hat_0(i(dz)) + hat_0(i(dy)) + hat_0(i(dx))
    4  hat_0(i(dz)) * hat_0(i(dy))
    5  sum_{z,y} T_c[z, y, 0, h] hat_z(i(dz)) hat_y(i(dy))  (per head)
    6  the trilinear sample of T_c: kernel C's bias        (per head)

T_c is corner c's table, (n, n, n, H) with axes z, y, x, head. Levels 0-5
run the Hopper kernel `csrc/rpe_ablate.cu`, which is kernel C's body
(`csrc/rpe_attention_fwd.cuh`) with only its bias loop changed; level 6
is kernel C itself (`ops.rpe_attention.rpe_cross_attention`). Levels 1-5
nest on the card: each also computes the lower levels' values and keeps
them live, so its time minus the previous level's is the cost of the
work it adds inside C's schedule. Level 6 is not built on level 5 (C
computes none of the sums and hats of levels 1-4), so no stage cost is
given for it. CUDA tensors launch the kernels (or raise); CPU tensors
take `rpe_ablate_plain`. On the CPU the entry point runs the plain
versions once and prints their shapes: it times nothing there.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vdetr_tpu_torch import kernels
from vdetr_tpu_torch.ops.rpe import log_quantize, trilinear_sample
from vdetr_tpu_torch.ops.rpe_attention import rpe_cross_attention
from vdetr_tpu_torch.tools import bound_ms, card, time_ms

# each level by what the CUDA body adds (`csrc/rpe_attention_fwd.cuh`)
LABELS = ("0: flash only", "1: +deltas", "2: +quantize x3", "3: +hat_0 x3",
          "4: +hat_0 product z,y", "5: +4 taps, x=0 plane",
          "6: kernel C, 8 taps")
LEVELS = range(len(LABELS))
NESTED = range(1, 6)  # levels that contain the previous level's work
# the tool's shapes: the published decoder's cross-attention at batch 1
B, NQ, NK, H, HD, N = 1, 1024, 4096, 4, 64, 10
LOG_SCALE, MAX_VALUE = 512.0, 4.0
# table taps per corner of each level's bias (the bound counts them)
_TAPS = (0, 0, 0, 0, 0, 4, 8)


def make_inputs(nq: int = NQ, nk: int = NK, device="cuda", seed: int = 0,
                scale: float = 1.0):
    """The tool's inputs (`tools/rpe_ablate.py:137-144`, the same numpy
    draws) in the port's layouts: q (B, nQ, H, hd), k and v (B, nK, hd),
    corners (B, nQ, 8, 3), key_xyz (B, nK, 3), tables (8, n, n, n, H).
    `scale` multiplies the corner and key coordinates."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, nq, HD).astype(np.float32) * 0.1
    k = rng.randn(B, nk, HD).astype(np.float32) * 0.1
    v = rng.randn(B, nk, HD).astype(np.float32)
    corners = rng.rand(B, nq, 24).astype(np.float32) * 6
    kxyz = rng.rand(B, 3, nk).astype(np.float32) * 6
    tables = rng.randn(8, N * N, N * H).astype(np.float32)
    arrays = (q.transpose(0, 2, 1, 3), k, v,
              corners.reshape(B, nq, 8, 3) * np.float32(scale),
              kxyz.transpose(0, 2, 1) * np.float32(scale),
              tables.reshape(8, N, N, N, H))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def _index(delta, n: int):
    """The continuous table index of a delta (the JAX `_quantize`)."""
    return ((log_quantize(delta, LOG_SCALE, MAX_VALUE) + 1.0) * n - 1.0) * 0.5


def _hats(idx, n: int):
    """(..., n) hat weights of every lattice point j: max(1 - |j - i|, 0)."""
    j = torch.arange(n, dtype=idx.dtype, device=idx.device)
    return torch.clamp(1.0 - torch.abs(j - idx[..., None]), min=0.0)


def ablate_bias_plain(level: int, corners, key_xyz, tables):
    """(B, H, nQ, nK) bias of `level` (module docstring), summed over the
    8 corners."""
    Bq, nQ = corners.shape[:2]
    nK = key_xyz.shape[1]
    n, Hh = tables.shape[1], tables.shape[-1]
    bias = corners.new_zeros(Bq, Hh, nQ, nK)
    if level == 0:
        return bias
    for c in range(8):
        dx, dy, dz = (corners[:, :, c, a:a + 1] - key_xyz[:, None, :, a]
                      for a in range(3))
        if level == 1:
            bias = bias + (dx + dy + dz)[:, None]
            continue
        if level == 6:
            bias = bias + trilinear_sample(
                tables[c], log_quantize(dx, LOG_SCALE, MAX_VALUE),
                log_quantize(dy, LOG_SCALE, MAX_VALUE),
                log_quantize(dz, LOG_SCALE, MAX_VALUE)).transpose(0, 1)
            continue
        iw, ih, iz = _index(dx, n), _index(dy, n), _index(dz, n)
        if level == 2:
            bias = bias + (iw + ih + iz)[:, None]
        elif level == 3:
            bias = bias + (_hats(iz, n)[..., 0] + _hats(ih, n)[..., 0]
                           + _hats(iw, n)[..., 0])[:, None]
        elif level == 4:
            bias = bias + (_hats(iz, n)[..., 0] * _hats(ih, n)[..., 0])[:, None]
        else:  # 5: bilinear in the x = 0 plane, one (B, nQ, nK, H) per z
            hz, hy = _hats(iz, n), _hats(ih, n)
            plane = tables[c, :, :, 0, :]                       # (z, y, H)
            u = sum(hz[..., z, None] * torch.matmul(hy, plane[z])
                    for z in range(n))
            bias = bias + u.permute(0, 3, 1, 2)
    return bias


def rpe_ablate_plain(level: int, q, k, v, corners, key_xyz, tables):
    """Plain version of level `level` with the (B, H, nQ, nK) logits
    materialized; q (B, nQ, H, hd), out (B, nQ, H, hd). Level 6 equals
    `rpe_cross_attention_plain` without mask or rotation."""
    attn = torch.einsum("bqhd,bkd->bhqk", q, k)
    attn = attn + ablate_bias_plain(level, corners, key_xyz, tables)
    return torch.einsum("bhqk,bkd->bqhd", torch.softmax(attn, dim=-1), v)


def logit_stats(level: int, q, k, v, corners, key_xyz, tables):
    """(max |logit|, the least gap between a row's two largest logits, the
    logits' rounding allowance: 16 ulps of max(1, max |logit|)). A logit
    sums q . k and up to 64 bias terms (8 corners x 8 taps at level 6)
    whose partial sums stay about the logit's size; their rounding adds
    up to a few ulps, and the allowance leaves >= 30x over the
    differences measured on the CPU and on the card."""
    logits = (torch.einsum("bqhd,bkd->bhqk", q, k)
              + ablate_bias_plain(level, corners, key_xyz, tables))
    top2 = torch.topk(logits, 2, dim=-1).values
    max_logit = float(logits.abs().max())
    return (max_logit, float((top2[..., 0] - top2[..., 1]).min()),
            16 * 2.0 ** -24 * max(1.0, max_logit))


def rounding_tol(level: int, q, k, v, corners, key_xyz, tables) -> float:
    """Absolute tolerance between two float32 evaluations of a level, in
    any order. Softmax is 1/2-Lipschitz from the logits' max norm to the
    probabilities' 1-norm, so |d out| <= 2 max|v| max|d logit| whatever
    the top-2 margin: a near tie cannot amplify rounding; max|d logit| is
    `logit_stats`' rounding allowance."""
    bound = logit_stats(level, q, k, v, corners, key_xyz, tables)[2]
    return 2 * float(v.abs().max()) * bound


def sdpa_layout(q, k, v):
    """q (B, nQ, H, hd), k and v (B, nK, hd) as SDPA's (B, H, n, hd)."""
    heads = q.shape[2]
    return (q.transpose(1, 2).contiguous(),
            k[:, None].expand(-1, heads, -1, -1).contiguous(),
            v[:, None].expand(-1, heads, -1, -1).contiguous())


def flash_library(qh, kh, vh):
    """Level 0 as one PyTorch call (the yardstick only): SDPA at scale 1
    on `sdpa_layout`'s tensors; out (B, H, nQ, hd)."""
    return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh,
                                                            scale=1.0)


def rpe_ablate(level: int, q, k, v, corners, key_xyz, tables):
    """Level `level` of the ablation on the tool's `log_scale` and
    `max_value`: levels 0-5 launch `csrc/rpe_ablate.cu`, level 6 kernel C;
    CPU tensors take `rpe_ablate_plain`."""
    if level not in LEVELS:
        raise ValueError(f"level {level}: the ablation has levels 0-6")
    if not q.is_cuda:
        return rpe_ablate_plain(level, q, k, v, corners, key_xyz, tables)
    if level == 6:
        return rpe_cross_attention(q, k, v, corners, None, key_xyz, tables,
                                   None, log_scale=LOG_SCALE,
                                   max_value=MAX_VALUE)
    Bq, nQ, Hh, hd = q.shape
    nK = k.shape[1]
    n = tables.shape[1]
    if Hh != H or hd != HD:
        raise ValueError(f"the ablation kernel is built for {H} heads of "
                         f"width {HD}; got H={Hh}, hd={hd}")
    f32 = torch.float32
    kernels.check(q, f32, (Bq, nQ, H, HD), "q")
    kernels.check(k, f32, (Bq, nK, HD), "k")
    kernels.check(v, f32, (Bq, nK, HD), "v")
    kernels.check(corners, f32, (Bq, nQ, 8, 3), "corners")
    kernels.check(key_xyz, f32, (Bq, nK, 3), "key_xyz")
    kernels.check(tables, f32, (8, n, n, n, H), "tables")
    out = torch.empty_like(q)
    kernels.call("rpe_ablate", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 corners.data_ptr(), key_xyz.data_ptr(), tables.data_ptr(),
                 out.data_ptr(), Bq, nQ, nK, H, HD, n, LOG_SCALE, MAX_VALUE,
                 level, torch.cuda.current_stream(q.device).cuda_stream)
    rpe_ablate.launches += 1
    return out


rpe_ablate.launches = 0


def attention_flops(pairs: int, heads: int, hd: int, taps: int) -> int:
    """The flops that bound the RPE attention (kernel C: 8 taps) and each
    ablation level: per (head, query, key) the q.k and p.v products (4 hd)
    and the softmax's exp and sums (~4); per (query, key) pair and corner
    `taps` table multiply-adds of all heads (2 per head). The index
    arithmetic (deltas, log-quantize, hats, tap weights) is not counted:
    its count depends on how it is written and its log2 runs on another
    unit, so the bound is a floor."""
    return pairs * heads * (4 * hd + 4) + pairs * 8 * taps * heads * 2


def level_bound(level: int, q, k, v, corners, key_xyz, tables):
    """(bound ms, what bounds it) of one level: `attention_flops` with the
    level's taps; each input the level reads and the output moved once."""
    Bq, nQ, Hh, hd = q.shape
    flops = attention_flops(Bq * nQ * k.shape[1], Hh, hd, _TAPS[level])
    used = [q, k, v] + ([corners, key_xyz] if level else []) \
        + ([tables] if level >= 5 else [])
    nbytes = sum(t.numel() * t.element_size() for t in used) + q.numel() * 4
    return bound_ms(nbytes, flops)


def run_levels(inputs, reps: int = 20):
    """Each level timed on the card over `reps` calls (CUDA events). Per
    level a dict of its label, ms, the stage's cost (ms minus the previous
    level's, for the nested levels 1-5 only) and its bound."""
    rows, prev = [], None
    for level in LEVELS:
        ms = time_ms(lambda: rpe_ablate(level, *inputs), reps)
        b_ms, b_by = level_bound(level, *inputs)
        rows.append(dict(level=level, label=LABELS[level], ms=ms,
                         stage_ms=ms - prev if level in NESTED else None,
                         bound_ms=b_ms, bound_by=b_by))
        prev = ms
    return rows


def format_rows(rows):
    """The level table: device ms, stage cost and bound."""
    lines = [f"{'level':26s} {'device ms':>10s} {'stage ms':>10s} "
             f"{'bound ms':>10s}"]
    for r in rows:
        stage = "" if r["stage_ms"] is None else f"{r['stage_ms']:+.4f}"
        lines.append(f"{r['label']:26s} {r['ms']:10.4f} {stage:>10s} "
                     f"{r['bound_ms']:10.4f} ({r['bound_by']})")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("rpe_ablate: no CUDA device (--device cpu runs the "
                         "plain versions)")
    inputs = make_inputs(NQ, NK, args.device)
    print(f"B {B}, nQ {NQ}, nK {NK}, H {H}, hd {HD}, n {N}, log_scale "
          f"{LOG_SCALE}, max_value {MAX_VALUE}")
    if args.device == "cpu":
        print("device: cpu, the plain versions once (no timing)")
        for level in LEVELS:
            out = rpe_ablate(level, *inputs)
            print(f"{LABELS[level]:26s} out {tuple(out.shape)}")
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card()}")
    for line in format_rows(run_levels(inputs)):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
