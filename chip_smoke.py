#!/usr/bin/env python3
"""Smoke test of the PyTorch port (vdetr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit;
  2. build: compiles the CUDA kernels of vdetr_tpu_torch/csrc for sm_90a,
     one nvcc per source, all at once;
  3. kernels: each kernel's wrapper against its plain PyTorch version on
     the card, at the shapes the published model gives it, with TF32
     off: the keyed conv (A) and its weight gradient (D), FPS (B), the
     RPE attention forward (C, eval and training form with dropout and
     the log-sum-exp) and its flash backward (F, dropout 0 and 0.1);
     prints the error, its tolerance, both times and the kernel's bound;
  4. forward: the published VDETR (VDETRConfig() defaults, seeded random
     weights) on synthetic 100k-point scenes at batch 1 and 4 under
     torch.inference_mode(): outputs finite and of the expected shapes,
     every kernel launched the expected number of times, median ms per
     scene and peak memory; and a small model whose kernel forward on
     the card agrees with the plain forward on the CPU;
  5. train: the published model's train step (Trainer, matcher "jv",
     batch 1, dropout on): a warm step, then timed steps with finite
     loss and gradients and the expected launches of A, B, C, D and F
     per step, median ms per step, peak memory and a breakdown by phase;
     and a small model's step on the card against the same step on the
     CPU (dropout 0): loss, every gradient and the updated parameters;
  6. a JSON line of per-kernel results, then the last line
     {"ok": true, "device": {...}} -- printed only when every phase
     passed.

Exits non-zero without printing a result when CUDA is unavailable, or
when any phase fails. Imports no jax.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
REPO_SOURCES = {
    "keyed_conv": ("vdetr_tpu_torch/csrc/keyed_conv.cu",
                   "vdetr_tpu/ops/sparse_conv_keyed.py:442"),
    "fps": ("vdetr_tpu_torch/csrc/fps.cu", "vdetr_tpu/ops/fps.py:115"),
    "rpe_cross_attention": ("vdetr_tpu_torch/csrc/rpe_attention.cu",
                            "vdetr_tpu/ops/rpe_attention.py:354"),
    "keyed_conv_dw": ("vdetr_tpu_torch/csrc/keyed_conv_dw.cu",
                      "vdetr_tpu/ops/sparse_conv_keyed.py:513"),
    "rpe_cross_attention_bwd": ("vdetr_tpu_torch/csrc/rpe_attention_bwd.cu",
                                "vdetr_tpu/ops/rpe_attention.py:561"),
}
# the card's peaks (NVIDIA's H100 SXM data sheet, at the 700 W limit):
# f32 outside the tensor cores and device-memory bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# no single PyTorch call computes any of these kernels' functions
LIBRARY_NONE = {
    "keyed_conv": "sparse 3^3 conv over hashed voxel keys: no torch op",
    "fps": "furthest point sampling: no torch op",
    "rpe_cross_attention": "attention with an 8-corner trilinear table "
                           "bias: SDPA takes no such bias without "
                           "materializing it",
    "keyed_conv_dw": "weight gradient of the keyed sparse conv: no torch op",
    "rpe_cross_attention_bwd": "backward of the above, with the table "
                               "gradient: no torch op",
}


def log(*args):
    print(*args, flush=True)


def bound_ms(nbytes: float, flops: float):
    """(least ms the card could take, what bounds it): bytes over the
    memory rate against flops over the f32 CUDA-core rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dominant(cases) -> str:
    """What bounds the case with the largest bound."""
    return max(cases, key=lambda c: c["bound_ms"])["bound_by"]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call on the device (CUDA events around `reps` calls)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synthetic_batch(num_points: int, batch: int, device, first: int = 0):
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.data.synthetic import (SyntheticDetectionDataset,
                                                collate)

    ds = SyntheticDetectionDataset(ScannetDatasetConfig(), num_points,
                                   seed=SEED)
    b = collate([ds[first + i] for i in range(batch)])
    keys = ("point_clouds", "point_validity", "point_cloud_dims_min",
            "point_cloud_dims_max")
    return {k: torch.from_numpy(b[k]).to(device) for k in keys}


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------------

def level_grids(cfg, device):
    """The voxel levels of one synthetic scene at the published
    capacities: [raw 1 cm, stem, stage 1 .. 4]."""
    from vdetr_tpu_torch.ops.voxelize import downsample_grid, voxelize

    inp = synthetic_batch(cfg.num_points, 1, device)
    caps = cfg.stage_capacities()
    g = voxelize(inp["point_clouds"], inp["point_clouds"],
                 inp["point_validity"], voxel_size=cfg.voxel_size,
                 capacity=caps[0], extent=cfg.grid_extent)
    grids = [g]
    for cap in caps[1:]:
        grids.append(downsample_grid(grids[-1], cap))
    return grids


def conv_cases(cfg, grids, gen):
    """The published shapes of four 3^3 convs: the stem, a stage-1
    submanifold conv, a stride-2 conv into stage 2, a stage-4 conv. Per
    case (label, kernel A's args, a premasked dout, neighbour hits)."""
    from vdetr_tpu_torch.ops.sparse_conv_keyed import neighbour_map

    device = grids[0].keys.device
    w = cfg.inplanes
    cases = [(0, 1, 3, w), (2, 2, w, w), (2, 3, w, 2 * w),
             (5, 5, 8 * w, 8 * w)]
    out = []
    for li, lo, cin, cout in cases:
        gi, go = grids[li], grids[lo]
        feats = torch.randn(gi.keys.shape + (cin,), generator=gen,
                            device=device) * gi.valid[..., None]
        wt = torch.randn(27, cin, cout, generator=gen, device=device)
        wt = wt * (2.0 / (27 * cin)) ** 0.5
        q = go.coords if li == lo else go.coords * 2
        args = (feats.contiguous(), gi.keys, q.contiguous(), go.valid,
                gi.extent, wt)
        dout = (torch.randn(go.keys.shape + (cout,), generator=gen,
                            device=device) * go.valid[..., None]).contiguous()
        hits = int((neighbour_map(gi.keys, args[2], go.valid, gi.extent)
                    < gi.capacity).sum())
        label = (f"{cin}->{cout} {'submanifold' if li == lo else 'stride-2'}"
                 f" V_in={gi.capacity} V={go.capacity} "
                 f"valid={int(go.valid.sum())}")
        out.append((label, args, dout, hits))
    return out


def check_conv_kernel(name, cases, kernel, plain, rel_tol, reason,
                      weight_grad=False):
    """Kernel A (or, with weight_grad, D) against its plain version on
    each conv case; per case the error, both times and the bound."""
    errs, ms, plain_ms, bound, out_cases = [], 0.0, 0.0, 0.0, []
    for label, args, dout, hits in cases:
        kargs = args[:5] + (dout,) if weight_grad else args
        got = kernel(*kargs)
        ref = plain(*kargs)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        tol = rel_tol * max(1.0, scale)
        t_k = time_ms(lambda: kernel(*kargs), reps=10)
        t_p = time_ms(lambda: plain(*kargs), reps=3)
        cin, cout = args[5].shape[1:]
        b_ms, b_by = bound_ms(nbytes(*kargs[:4], kargs[5]) + ref.numel() * 4,
                              2.0 * cin * cout * hits)
        ok = err <= tol
        log(f"check {name} {label}: max_abs_err={err:.3e} "
            f"(max|ref|={scale:.3e}) tol={tol:.3e} -> {'ok' if ok else 'FAIL'};"
            f" kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound {b_ms:.4f} ms"
            f" ({b_by})")
        errs.append((err, ok))
        ms += t_k
        plain_ms += t_p
        bound += b_ms
        out_cases.append({"case": label, "max_abs_err": err, "ms": t_k,
                          "plain_ms": t_p, "bound_ms": b_ms,
                          "bound_by": b_by})
    log("  tolerance reason: " + reason)
    return dict(ok=all(ok for _, ok in errs), err=max(e for e, _ in errs),
                ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=_dominant(out_cases), cases=out_cases)


def check_keyed_conv(cases):
    from vdetr_tpu_torch.ops.sparse_conv_keyed import (keyed_conv,
                                                       keyed_conv_plain)

    return check_conv_kernel(
        "keyed_conv", cases, keyed_conv, keyed_conv_plain, 1e-4,
        "float32 sums of up to 27*C_in products taken in another order "
        "than the plain per-offset matmuls; 1e-4 of max|ref| is ~10x the "
        "sqrt(n)*2^-24 rounding spread at n = 27*512")


def check_keyed_conv_dw(cases):
    from vdetr_tpu_torch.ops.sparse_conv_keyed import (keyed_conv_dw,
                                                       keyed_conv_dw_plain)

    return check_conv_kernel(
        "keyed_conv_dw", cases, keyed_conv_dw, keyed_conv_dw_plain, 2e-5,
        "each dW entry is a float32 sum over up to 65536 rows, taken in "
        "16-row register tiles and a fixed-order sum of row splits against "
        "the plain version's GEMM order; 2e-5 of max|ref| is ~10x the "
        "rounding spread measured on the card", weight_grad=True)


def check_fps(cfg, grids):
    from vdetr_tpu_torch.ops.fps import furthest_point_sample, fps_plain

    out_level = grids[2]  # the FPN output level (stride 4)
    xyz = (out_level.world_xyz() * out_level.valid[..., None]).contiguous()
    got = furthest_point_sample(xyz, cfg.preenc_npoints)
    t0 = time.perf_counter()
    ref = fps_plain(xyz, cfg.preenc_npoints)
    torch.cuda.synchronize()
    t_p = (time.perf_counter() - t0) * 1e3
    mism = int((got != ref).sum())
    err = float((got - ref).abs().max())
    ok = mism == 0
    t_k = time_ms(lambda: furthest_point_sample(xyz, cfg.preenc_npoints),
                  reps=5)
    # per step and point: 3 differences, a product and two fused
    # multiply-adds, a min and a compare: 10 flops
    n = xyz.shape[0] * xyz.shape[1]
    b_ms, b_by = bound_ms(nbytes(xyz) + got.numel() * 8,
                          10.0 * n * cfg.preenc_npoints)
    log(f"check fps N={xyz.shape[1]} (valid={int(out_level.valid.sum())}) "
        f"npoint={cfg.preenc_npoints}: {mism} indices differ, tolerance 0 "
        f"(both round fma(dz,dz,fma(dy,dy,dx*dx)) exactly) -> "
        f"{'ok' if ok else 'FAIL'}; kernel {t_k:.3f} ms, plain {t_p:.1f} ms"
        f" (one timed call), bound {b_ms:.4f} ms ({b_by})")
    return dict(ok=ok, err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by)


def rpe_case(cfg, device, gen, B=1):
    """Decoder-shaped inputs: q (B, nQ, H, hd), a shared K/V head, box
    corners from random boxes in a room, a partial key mask."""
    from vdetr_tpu_torch.geometry.boxes import (
        box_parametrization_to_corners, convert_corners_camera2lidar)

    nQ, nK, H = cfg.nqueries, cfg.preenc_npoints, cfg.dec_nhead
    hd = cfg.dec_dim // H
    n = cfg.rpe_table_size

    def r(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    q = torch.randn(B, nQ, H, hd, generator=gen, device=device) * hd ** -0.5
    k = torch.randn(B, nK, hd, generator=gen, device=device)
    v = torch.randn(B, nK, hd, generator=gen, device=device)
    centers = r(B, nQ, 3) * torch.tensor([6.0, 6.0, 2.0], device=device)
    sizes = r(B, nQ, 3) * 1.5 + 0.1
    angles = (r(B, nQ) - 0.5) * 6.2
    corners = convert_corners_camera2lidar(
        box_parametrization_to_corners(centers, sizes, angles)).contiguous()
    key_xyz = r(B, nK, 3) * torch.tensor([6.0, 6.0, 2.5], device=device)
    tables = torch.randn(8, n, n, n, H, generator=gen, device=device)
    key_valid = r(B, nK) > 0.1
    return q, k, v, corners, angles, key_xyz, tables, key_valid


def rpe_bound(case, train: bool, backward: bool = False):
    """Bytes each input and output once; flops per (head, query, key):
    the q.k and p.v products (4 hd) and the softmax's exp and sums (~4),
    per (query, key) pair 8 corners x 8 taps x H multiply-adds for the
    bias (or, backward, for dTables); the backward's dO.V and ds.K
    products replace q.k and p.v."""
    q, k, v, corners, angles, key_xyz, tables, key_valid = case
    B, nQ, H, hd = q.shape
    nK = k.shape[1]
    pairs = B * nQ * nK
    flops = pairs * H * (4 * hd + 4) + pairs * 8 * 8 * H * 2
    score_bytes = pairs * H * 4  # one (B, H, nQ, nK) f32 tensor
    if backward:  # reads logits, writes ds and eg; dq, dtables out
        io = (nbytes(k, v, corners, key_xyz, key_valid) + 2 * nbytes(q)
              + 3 * score_bytes + nbytes(q, tables))
    else:
        io = nbytes(*case) + nbytes(q)
        if train:
            io += score_bytes + B * nQ * H * 4
    return bound_ms(io, flops)


def check_rpe(cfg, device, gen):
    from vdetr_tpu_torch.ops.rpe_attention import (rpe_cross_attention,
                                                   rpe_cross_attention_plain)

    case = rpe_case(cfg, device, gen)
    ok_all, errs, t_k, t_p = True, [], 0.0, 0.0
    for rotate in (False, True):
        kw = dict(log_scale=cfg.log_scale, max_value=cfg.rpe_max_value,
                  rotate=rotate)
        got = rpe_cross_attention(*case, **kw)
        ref = rpe_cross_attention_plain(*case, **kw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = 1e-4
        ok = err <= tol
        ok_all &= ok
        errs.append(err)
        tk = time_ms(lambda: rpe_cross_attention(*case, **kw), reps=10)
        tp = time_ms(lambda: rpe_cross_attention_plain(*case, **kw), reps=3)
        if not rotate:
            t_k, t_p = tk, tp
        q = case[0]
        log(f"check rpe_cross_attention B={q.shape[0]} nQ={q.shape[1]} "
            f"nK={case[1].shape[1]} H={q.shape[2]} hd={q.shape[3]} "
            f"rotate={rotate} keys masked={int((~case[7]).sum())}: "
            f"max_abs_err={err:.3e} tol={tol:.1e} -> "
            f"{'ok' if ok else 'FAIL'}; kernel {tk:.3f} ms, plain {tp:.3f} ms")
    log("  tolerance reason: outputs are O(1) convex combinations of V; the "
        "kernel sums 64 bias taps and the softmax in another order and uses "
        "CUDA's log2f/expf (<= 2 ulp), so ~1e-6 relative logit error; 1e-4 "
        "leaves ~10x margin")
    b_ms, b_by = rpe_bound(case, train=False)
    ok_t, err_t, t_train = check_rpe_train(cfg, case)
    return dict(ok=ok_all and ok_t, err=max(errs + [err_t]), ms=t_k,
                plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                train_ms=t_train), case


def check_rpe_train(cfg, case, rate: float = 0.1):
    """Kernel C's training form: dropout 0.1 from a seed on the card, the
    log-sum-exp and the stored logits, against the plain version with the
    same hash mask."""
    from vdetr_tpu_torch.ops.rpe_attention import (rpe_cross_attention,
                                                   rpe_cross_attention_plain)

    seed = torch.tensor([12345], dtype=torch.int64, device=case[0].device)
    kw = dict(log_scale=cfg.log_scale, max_value=cfg.rpe_max_value,
              dropout_rate=rate, seed=seed, return_stats=True)
    out, lse, logits = rpe_cross_attention(*case, **kw)
    r_out, r_lse, r_logits = rpe_cross_attention_plain(*case, **kw)
    torch.cuda.synchronize()
    valid = case[7][:, None, None, :].expand_as(logits)
    errs = {"out": float((out - r_out).abs().max()),
            "lse": float((lse - r_lse).abs().max()),
            "logits": float((logits - r_logits)[valid].abs().max())}
    tols = {"out": 1e-4, "lse": 1e-4, "logits": 1e-4}
    ok = all(errs[k] <= tols[k] for k in errs)
    t_k = time_ms(lambda: rpe_cross_attention(*case, **kw), reps=10)
    t_p = time_ms(lambda: rpe_cross_attention_plain(*case, **kw), reps=3)
    b_ms, b_by = rpe_bound(case, train=True)
    log(f"check rpe_cross_attention train form dropout={rate}: max_abs_err "
        + ", ".join(f"{k} {v:.3e} (tol {tols[k]:.0e})" for k, v in errs.items())
        + f" -> {'ok' if ok else 'FAIL'}; kernel {t_k:.3f} ms, plain "
        f"{t_p:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    log("  tolerance reason: as the eval form; the dropout masks are equal "
        "(one integer hash in both), so the error is the softmax rounding; "
        "logits compared at valid keys, O(10) values with ~1e-6 relative "
        "error")
    return ok, max(errs.values()), t_k


def check_rpe_bwd(cfg, case):
    """Kernel F against its plain version at dropout 0 and 0.1, from the
    plain training forward's logits and lse."""
    from vdetr_tpu_torch.ops.rpe_attention import (
        rpe_cross_attention_bwd, rpe_cross_attention_bwd_plain,
        rpe_cross_attention_plain)

    q, k, v, corners, angles, key_xyz, tables, key_valid = case
    n = tables.shape[1]
    seed = torch.tensor([777], dtype=torch.int64, device=q.device)
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=q.device).manual_seed(SEED + 7), device=q.device)
    ok_all, worst, times = True, 0.0, {}
    for rate in (0.0, 0.1):
        fkw = dict(log_scale=cfg.log_scale, max_value=cfg.rpe_max_value,
                   dropout_rate=rate, seed=seed)
        out, lse, logits = rpe_cross_attention_plain(*case, return_stats=True,
                                                     **fkw)
        args = (k, v, corners, angles, key_xyz, key_valid, out, dout, logits,
                lse, n)
        got = rpe_cross_attention_bwd(*args, **fkw)
        ref = rpe_cross_attention_bwd_plain(*args, **fkw)
        torch.cuda.synchronize()
        parts = []
        for name, g, r in zip(("dq", "dtables", "ds", "eg"), got, ref):
            scale = float(r.abs().max())
            err = float((g - r).abs().max())
            tol = 1e-4 * max(1.0, scale)
            ok_all &= err <= tol
            worst = max(worst, err)
            parts.append(f"{name} {err:.3e} (max|ref| {scale:.2e}, tol "
                         f"{tol:.1e})")
        t_k = time_ms(lambda: rpe_cross_attention_bwd(*args, **fkw), reps=5)
        t_p = time_ms(lambda: rpe_cross_attention_bwd_plain(*args, **fkw),
                      reps=2)
        times[rate] = (t_k, t_p)
        log(f"check rpe_cross_attention_bwd dropout={rate}: "
            + "; ".join(parts) + f" -> {'ok' if ok_all else 'FAIL'}; kernel "
            f"{t_k:.3f} ms, plain {t_p:.3f} ms")
    b_ms, b_by = rpe_bound(case, train=True, backward=True)
    log(f"  bound {b_ms:.4f} ms ({b_by}); tolerance reason: dq sums 4096 "
        "keys, dtables ~4M pairs through atomics in no fixed order, both "
        "float32: ~1e-6 relative spread per term; 1e-4 of max|ref| leaves "
        "~10x margin over the spread measured on the card")
    t_k, t_p = times[0.1]
    return dict(ok=ok_all, err=worst, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by)


# --------------------------------------------------------------------------
# phase 4: the published forward
# --------------------------------------------------------------------------

def expected_launches(model, cfg, train: bool = False):
    """Kernel launches of one forward, or of one train step: A once per
    3^3 conv forward and again for each submanifold conv's dFeats, D
    once per 3^3 conv, C and F once per decoder layer, FPS once."""
    from vdetr_tpu_torch.models.backbone import SparseConv, SparseConvDown

    k3 = [m for m in model.modules()
          if isinstance(m, (SparseConv, SparseConvDown))
          and m.kernel_size == 3]
    layers = cfg.dec_nlayers - 1
    out = {"keyed_conv": len(k3), "fps": 1, "rpe_cross_attention": layers}
    if train:
        out["keyed_conv"] += sum(isinstance(m, SparseConv) for m in k3)
        out["keyed_conv_dw"] = len(k3)
        out["rpe_cross_attention_bwd"] = layers
    return out


def launch_counters():
    from vdetr_tpu_torch.ops.fps import furthest_point_sample
    from vdetr_tpu_torch.ops.rpe_attention import (rpe_cross_attention,
                                                   rpe_cross_attention_bwd)
    from vdetr_tpu_torch.ops.sparse_conv_keyed import (keyed_conv,
                                                       keyed_conv_dw)

    return {"keyed_conv": keyed_conv, "fps": furthest_point_sample,
            "rpe_cross_attention": rpe_cross_attention,
            "keyed_conv_dw": keyed_conv_dw,
            "rpe_cross_attention_bwd": rpe_cross_attention_bwd}


def check_outputs(out, cfg, B, num_semcls):
    nq, ns = cfg.nqueries, cfg.preenc_npoints
    shapes = {"sem_cls_logits": (B, nq, num_semcls),
              "box_corners": (B, nq, 8, 3), "center_unnormalized": (B, nq, 3),
              "size_unnormalized": (B, nq, 3), "objectness_prob": (B, nq)}
    bad = [f"{k}{tuple(out['outputs'][k].shape)}!={s}"
           for k, s in shapes.items() if tuple(out["outputs"][k].shape) != s]
    if len(out["aux_outputs"]) != cfg.dec_nlayers - 1:
        bad.append(f"{len(out['aux_outputs'])} aux outputs")
    if tuple(out["seed_xyz"].shape) != (B, ns, 3):
        bad.append(f"seed_xyz {tuple(out['seed_xyz'].shape)}")
    for i, pred in enumerate([out["outputs"]] + out["aux_outputs"]):
        for k, v in pred.items():
            if not bool(torch.isfinite(v).all()):
                bad.append(f"layer {i} {k} not finite")
    return bad


def run_forward(cfg, device, gen, power):
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.models.vdetr import build_model

    ds = ScannetDatasetConfig()
    model = build_model(cfg, ds, generator=gen, device=device)
    expected = expected_launches(model, cfg)
    counters = launch_counters()
    ok, launches, per_batch = True, None, {}
    for B in (1, 4):
        inputs = synthetic_batch(cfg.num_points, B, device)
        with torch.inference_mode():
            for fn in counters.values():
                fn.launches = 0
            out = model(inputs)
            torch.cuda.synchronize()
            counts = {k: fn.launches for k, fn in counters.items()}
            bad = check_outputs(out, cfg, B, ds.num_semcls)
            cmp = {k: (counts[k], expected[k]) for k in expected}
            good_counts = all(c == e for c, e in cmp.values())
            if B == 1:
                launches = counts
            torch.cuda.reset_peak_memory_stats(device)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(inputs)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        med = statistics.median(times)
        per_batch[B] = med / B
        log(f"forward B={B} N={cfg.num_points}: launches "
            + ", ".join(f"{k} {c} (expected {e})" for k, (c, e) in cmp.items())
            + f"; outputs {'finite, shapes ok' if not bad else bad[:5]}; "
            f"median {med:.2f} ms ({med / B:.2f} ms/scene) over 5 warm runs "
            f"[{', '.join(f'{t:.1f}' for t in times)}]; peak memory "
            f"{peak:.2f} GiB; card {power}")
        ok &= good_counts and not bad
    return ok, launches, per_batch


def tiny_config():
    from vdetr_tpu_torch.config import VDETRConfig

    return VDETRConfig(
        voxel_capacity=2048, min_stage_capacity=128,
        grid_extent=(128, 128, 64), preenc_npoints=128, nqueries=64,
        dec_nlayers=3, dec_dim=32, dec_ffn_dim=32, dec_nhead=4, rpe_dim=16,
        inplanes=8, enc_dim=32, num_points=512)


def check_small_forward_against_cpu(device, gen):
    """The whole forward at a small size: kernels on the card against the
    plain versions on the CPU, same weights and inputs."""
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.models.vdetr import build_model

    cfg = tiny_config()
    model = build_model(cfg, ScannetDatasetConfig(), generator=gen,
                        device="cpu")
    with torch.no_grad():  # non-trivial heads and norm statistics
        for name, p in model.named_parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
        for name, b in model.named_buffers():
            if name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=gen)
            elif name.endswith("running_mean"):
                b.normal_(0.0, 0.1, generator=gen)
    rng = np.random.RandomState(SEED)
    pts = (rng.rand(2, cfg.num_points, 3) * [1.2, 1.2, 0.6]).astype(np.float32)
    inputs = {"point_clouds": torch.from_numpy(pts),
              "point_cloud_dims_min": torch.from_numpy(pts.min(1)),
              "point_cloud_dims_max": torch.from_numpy(pts.max(1))}
    with torch.inference_mode():
        ref = model(inputs)
        got = model.to(device)({k: v.to(device) for k, v in inputs.items()})
        torch.cuda.synchronize()
    seeds_equal = bool((got["seed_inds"].cpu() == ref["seed_inds"]).all())
    err = max(float((got["outputs"][k].cpu() - v).abs().max())
              for k, v in ref["outputs"].items())
    tol = 1e-3
    ok = seeds_equal and err <= tol
    log(f"forward small config on card vs CPU plain path: seeds equal="
        f"{seeds_equal}, max_abs_err over final outputs={err:.3e} tol={tol:.0e}"
        f" (f32 rounding through ~40 layers) -> {'ok' if ok else 'FAIL'}")
    return ok


# --------------------------------------------------------------------------
# phase 5: the train step
# --------------------------------------------------------------------------

def train_batch(cfg, B: int, first: int = 0):
    """Synthetic scenes with their ground truth, as numpy arrays."""
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.data.synthetic import (SyntheticDetectionDataset,
                                                collate)

    ds = SyntheticDetectionDataset(ScannetDatasetConfig(), cfg.num_points,
                                   seed=SEED)
    return collate([ds[first + i] for i in range(B)])


def grads_finite(model):
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    return bad


def step_breakdown(trainer, batch, gen):
    """One train step written out phase by phase, each phase ended by a
    synchronization: forward, criterion (its matcher copies the costs to
    the host), backward split at the decoder's input (CUDA events recorded
    when the gradient reaches the projection's output and when the
    backward ends), clip and AdamW. Host-clock ms per phase."""
    from vdetr_tpu_torch.train.engine import INPUT_KEYS
    from vdetr_tpu_torch.train.optimizer import clip_by_global_norm

    model, crit, opt = trainer.model, trainer.criterion, trainer.optimizer
    b = trainer._to_device(batch)
    inputs = {k: b[k] for k in INPUT_KEYS if k in b}
    ev = {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev[name] = e

    def on_projection(module, args, out):  # returns None: output kept
        out.register_hook(lambda g: mark("decoder_done"))

    hook = model.encoder_to_decoder_projection.register_forward_hook(
        on_projection)
    t = {}
    model.train()
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model(inputs, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss, _ = crit(out, b)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    mark("backward_start")
    loss.backward()
    mark("backward_end")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    clip_by_global_norm(model.parameters(), trainer.cfg.clip_gradient)
    opt.step()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    hook.remove()
    t["forward"] = (t1 - t0) * 1e3
    t["criterion incl. matcher"] = (t2 - t1) * 1e3
    t["backward"] = (t3 - t2) * 1e3
    t["backward: decoder and heads (device)"] = ev["backward_start"] \
        .elapsed_time(ev["decoder_done"])
    t["backward: projection, FPN and backbone (device)"] = \
        ev["decoder_done"].elapsed_time(ev["backward_end"])
    t["clip and AdamW"] = (t4 - t3) * 1e3
    return t


def matcher_host_ms(trainer, batch, gen):
    """Host ms of the criterion's solve: the costs' copy to the host
    (after a synchronization, so the copy alone) and the JV solves."""
    from vdetr_tpu_torch.train.engine import INPUT_KEYS

    crit = trainer.criterion
    b = trainer._to_device(batch)
    with torch.no_grad():
        out = trainer.model({k: b[k] for k in INPUT_KEYS if k in b},
                            generator=gen)
    orig = crit.solve_costs
    spent = {}

    def timed(costs, nactual):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(costs, nactual)
        spent["ms"] = (time.perf_counter() - t0) * 1e3
        return res

    crit.solve_costs = timed
    try:
        with torch.no_grad():
            crit(out, b)
    finally:
        crit.solve_costs = orig
    return spent["ms"]


def run_train(cfg, device, power, steps: int = 5):
    """The published model's train step at batch 1: a warm step, then
    `steps` timed steps, each with its launches counted."""
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.models.vdetr import build_model
    from vdetr_tpu_torch.train.engine import Trainer

    ds = ScannetDatasetConfig()
    model = build_model(cfg, ds, generator=torch.Generator().manual_seed(
        SEED), device=device)
    trainer = Trainer(cfg, model, ds, steps_per_epoch=1000, device=device)
    expected = expected_launches(model, cfg, train=True)
    counters = launch_counters()
    gen = torch.Generator(device=device).manual_seed(SEED)
    batches = [train_batch(cfg, 1, first=i) for i in range(steps + 1)]
    ok, bad, times, launches = True, [], [], None
    torch.cuda.reset_peak_memory_stats(device)
    for i, batch in enumerate(batches):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, parts = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        counts = {k: fn.launches for k, fn in counters.items()}
        nonfinite = grads_finite(model)
        step_ok = (math.isfinite(loss) and not nonfinite
                   and counts == expected)
        ok &= step_ok
        if i == 0:
            launches = counts
        else:
            times.append(dt)
        log(f"train step {i}{' (warm)' if i == 0 else ''}: loss {loss:.4f}, "
            f"{dt:.1f} ms, grads {'finite' if not nonfinite else nonfinite[:3]}"
            f", launches " + ", ".join(f"{k} {counts[k]} (expected "
                                       f"{expected[k]})" for k in expected)
            + f" -> {'ok' if step_ok else 'FAIL'}")
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    med = statistics.median(times)
    log(f"train B=1 N={cfg.num_points} matcher={cfg.matcher_impl}: median "
        f"{med:.1f} ms/step over {len(times)} steps "
        f"[{', '.join(f'{t:.1f}' for t in times)}]; peak memory {peak:.2f} "
        f"GiB; card {power}")
    brk = step_breakdown(trainer, batches[1], gen)
    brk["matcher: cost copy and JV on the host"] = matcher_host_ms(
        trainer, batches[1], gen)
    log("train step breakdown (ms): " + "; ".join(
        f"{k} {v:.1f}" for k, v in brk.items()))
    return ok, launches, dict(ms_per_step=med, steps=times,
                              peak_gib=peak, breakdown=brk)


def check_small_train_against_cpu(device):
    """One train step of a small model (dropout 0) on the card against
    the same step on the CPU through the plain versions: same weights,
    same batch."""
    import copy

    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.models.vdetr import build_model
    from vdetr_tpu_torch.train.engine import Trainer

    cfg = tiny_config().replace(voxel_size=0.05, num_points=1024, nqueries=32,
                                repeat_num=2, matcher_impl="jv",
                                dec_dropout=0.0, mlp_dropout=0.0,
                                warm_lr_epochs=0, max_epoch=10,
                                base_lr=1e-3)
    ds = ScannetDatasetConfig()
    cpu = build_model(cfg, ds, generator=torch.Generator().manual_seed(SEED),
                      device="cpu")
    card = copy.deepcopy(cpu).to(device)
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    batch = train_batch(cfg, 2, first=3)
    res = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, device)):
        tr = Trainer(cfg, model, ds, steps_per_epoch=1, device=dev)
        loss, _ = tr.train_step(batch, torch.Generator(device=dev))
        res[name] = (loss, {n: (p.grad.cpu(), p.detach().cpu())
                            for n, p in model.named_parameters()})
    (l_cpu, p_cpu), (l_card, p_card) = res["cpu"], res["card"]
    g_cpu = torch.cat([g.flatten() for g, _ in p_cpu.values()])
    g_card = torch.cat([p_card[n][0].flatten() for n in p_cpu])
    g_err = float((g_card - g_cpu).norm() / g_cpu.norm())
    worst = max(float((p_card[n][0] - g).abs().max() / g.abs().max().clamp(
        min=1e-30)) for n, (g, _) in p_cpu.items()
        if float(g.abs().max()) > 1e-6 * float(g_cpu.abs().max()))
    # the update of each parameter, where its gradient is not rounding
    # noise (Adam's first step moves those by +-lr on the noise's sign)
    top = float(g_cpu.abs().max())
    u_cpu, u_card = [], []
    for n, (g, p) in p_cpu.items():
        keep = g.abs() > 1e-6 * top
        u_cpu.append((p - before[n])[keep])
        u_card.append((p_card[n][1] - before[n])[keep])
    u_cpu, u_card = torch.cat(u_cpu), torch.cat(u_card)
    u_err = float((u_card - u_cpu).norm() / u_cpu.norm())
    l_err = abs(l_card - l_cpu) / abs(l_cpu)
    ok = l_err <= 1e-4 and g_err <= 1e-3 and worst <= 5e-2 and u_err <= 1e-3
    log(f"train step small config on card vs CPU plain path: loss "
        f"{l_card:.6f} vs {l_cpu:.6f} (rel err {l_err:.2e}, tol 1e-4); "
        f"gradients rel L2 err {g_err:.2e} (tol 1e-3), worst tensor "
        f"{worst:.2e} of its max (tol 5e-2); updates rel L2 err {u_err:.2e}"
        f" (tol 1e-3) -> {'ok' if ok else 'FAIL'}")
    log("  tolerance reason: f32 sums in other orders (~1e-6 relative per "
        "op) through ~80 layers of forward and backward; a ReLU input "
        "within rounding of 0 may take the other one-sided derivative on "
        "the card, which moves a few entries of some tensors by ~1% of "
        "their largest: hence the tensor-wise 5e-2 and the global 1e-3")
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test runs only on a CUDA device", file=sys.stderr)
        return 2
    from vdetr_tpu_torch import kernels
    from vdetr_tpu_torch.config import VDETRConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    paths = kernels.build_all()
    log(f"build: {len(paths)} kernels for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in paths.values()))

    # 3. kernels against their plain versions
    cfg = VDETRConfig()
    gen = torch.Generator(device=device).manual_seed(SEED)
    grids = level_grids(cfg, device)
    cases = conv_cases(cfg, grids, gen)
    res = {"keyed_conv": check_keyed_conv(cases),
           "keyed_conv_dw": check_keyed_conv_dw(cases)}
    del cases
    res["fps"] = check_fps(cfg, grids)
    res["rpe_cross_attention"], case = check_rpe(cfg, device, gen)
    res["rpe_cross_attention_bwd"] = check_rpe_bwd(cfg, case)
    del case, grids

    # 4. the published forward, then a small one against the CPU
    ok_f, fwd_launches, per_scene = run_forward(
        cfg, device, torch.Generator().manual_seed(SEED), smi)
    ok_s = check_small_forward_against_cpu(
        device, torch.Generator().manual_seed(SEED + 1))

    # 5. the published train step, then a small one against the CPU
    ok_t, train_launches, train = run_train(
        cfg.replace(matcher_impl="jv"), device, smi)
    ok_ts = check_small_train_against_cpu(device)

    record = {"kernels": []}
    for kname, r in res.items():
        src, repl = REPO_SOURCES[kname]
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": repl, "launches": train_launches[kname],
                 "max_abs_err": r["err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": None,
                 "library": "none: " + LIBRARY_NONE[kname]}
        if kname in fwd_launches:
            entry["forward_launches"] = fwd_launches[kname]
        for extra in ("cases", "train_ms"):
            if extra in r:
                entry[extra] = r[extra]
        record["kernels"].append(entry)
    record["forward_ms_per_scene"] = {f"B={b}": t for b, t in
                                      per_scene.items()}
    record["train"] = train
    record["card"] = smi
    log(json.dumps(record))
    if not (all(r["ok"] for r in res.values()) and ok_f and ok_s and ok_t
            and ok_ts):
        log("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
