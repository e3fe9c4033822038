#!/usr/bin/env python3
"""Smoke test of the PyTorch port (vdetr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit;
  2. build: compiles the CUDA kernels of vdetr_tpu_torch/csrc for sm_90a,
     one nvcc per source, all at once;
  3. kernels: each kernel's wrapper against its plain PyTorch version on
     the card, at the shapes the published model gives it, with TF32
     off: the keyed conv (A) and its weight gradient (D), the neighbour
     map (G) on the forward's nine maps at batch 1 and 4, alone and as
     the mapped forward launches them (the stem's map, then each stage's
     two maps in one launch), with the set's event time and device gaps,
     the mapped conv (H, also held to A) and its weight gradient (I), FPS
     (B, on one scene and on the four rows of an eval batch, with its
     exchange floor and ns a step beside the bound), the RPE attention
     forward (C, eval and training form with dropout and the
     log-sum-exp) and its flash backward (F, dropout 0 and 0.1, its pair
     kernel, the sum of the pair kernel's key shares, its dTables table
     kernel and the sum of the table kernel's slices also timed apart,
     its dq, dtables, ds and eg bit for bit from a second launch, the
     pair kernel's SASS read for tensor-core MMAs and atomics and the
     table kernel's for global atomics and compare-and-swap loops, the
     pair kernel's two products as torch.matmul beside it), and the
     slices' sum (bit for bit against its plain version); prints the
     error, its tolerance, both times and the kernel's bound (for A, D, H
     and I, which multiply on the tensor cores in split TF32, against the
     TF32 rate, with the f32 CUDA-core bound beside it); I bit for bit
     against D and against a second call of itself;
  3b. probes of kernel C, the work of the entry points
     `python -m vdetr_tpu_torch.tools.rpe_ablate` and `.dot_micro` at the
     tool shapes: each stage-ablation level 0-5 against its plain version,
     level 6 bit-equal to C, and the table of level times, stage costs and
     bounds; each table-contraction variant against its plain version and
     the einsum, with the einsum's time (TF32 off and on);
  4. forward, on both sparse-conv routes (conv_route "keyed", the
     default, and "mapped"): the published VDETR (VDETRConfig() defaults,
     seeded random weights, the same on both routes) on synthetic
     100k-point scenes at batch 1 and 4 under torch.inference_mode():
     outputs finite and of the expected shapes, every kernel launched
     the expected number of times, peak memory, and median ms per scene
     from timed runs of the two routes in turn; the two routes' FPN
     outputs agree; and a small model on each route whose kernel forward
     on the card agrees with the plain forward on the CPU;
  4b. eval step, on both routes: the published eval step
     (`Trainer.eval_step` with test_only: the forward, the focal sigmoid,
     empty-box removal on a fixed 40000-point subsample and the greedy
     same-class NMS, kernel N) at batch 1 and 4: its launches (the
     forward's and one of N), finite outputs, the boxes kept and peak
     memory, then median ms per scene of the step and of the forward
     alone, timed in turn; kernel N bit for bit against its plain loop on
     random boxes (exact score ties, pairs exactly at the threshold,
     holes in valid) at K = 1024, 1000 and 4097, B = 1 and 4, on chains
     of boxes each killing the next, and on the published steps' own NMS
     inputs, with its time, its mask and scan kernels' device times, the
     plain loop's and the bound; the VoteNet AP end to end
     (`evaluate`, `APCalculator`) over four synthetic scenes, naming its
     IoU path; and a small eval step on each route on the card against
     the CPU (keep mask equal, outputs within 1e-3);
  5. train, on both routes: the published model's train step (Trainer,
     matcher "jv", batch 1, dropout on), the two routes' steps in turn on
     the same batches: three warm steps, then timed steps with finite
     loss and gradients and the expected launches per step (A, D or G,
     H, I; B, C, F and its slices' sum), median ms per step, peak memory
     and a breakdown by phase (host ms, and the backward's stream spans),
     the same breakdown under torch.profiler (device ms per phase); the
     run-to-run spread of the gradients (two backwards from the same
     state, batch and seed), which must be exactly 0 for every
     parameter, and two whole steps from one state, which must leave the
     same parameters bit for bit (`vdetr_tpu_torch/tools/determinism.py`);
     one step per route under torch.profiler (device ms per kernel and
     per device function summed over its launches, the device's busy
     share); and a small
     model's step on each route on the card against the same step on the
     CPU (dropout 0): loss, every gradient and the updated parameters;
  6. a JSON line of per-kernel results, then the last line
     {"ok": true, "device": {...}} -- printed only when every phase
     passed.

Exits non-zero without printing a result when CUDA is unavailable, or
when any phase fails. Imports no jax.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vdetr_tpu_torch.tools import (PEAK_BYTES, PEAK_F32_FLOPS,
                                   PEAK_TF32_FLOPS, bound_ms,
                                   bound_split_tf32_ms, card, time_ms)

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
    "rpe_table_sum": ("vdetr_tpu_torch/csrc/rpe_table_sum.cu",
                      "vdetr_tpu/ops/rpe_attention.py:561"),
    "kernel_map": ("vdetr_tpu_torch/csrc/map_kernel.cu",
                   "vdetr_tpu/ops/map_kernel.py:185"),
    "mapped_conv": ("vdetr_tpu_torch/csrc/mapped_conv.cu",
                    "vdetr_tpu/ops/sparse_conv_kernel.py:202"),
    "mapped_conv_dw": ("vdetr_tpu_torch/csrc/mapped_conv_dw.cu",
                       "vdetr_tpu/ops/sparse_conv_kernel.py:293"),
    "rpe_ablate": ("vdetr_tpu_torch/csrc/rpe_ablate.cu",
                   "tools/rpe_ablate.py:147"),
    "dot_micro": ("vdetr_tpu_torch/csrc/dot_micro.cu",
                  "tools/dot_micro.py:74"),
    # no pallas_call: the JAX eval step's NMS is a jax.lax.while_loop
    "nms": ("vdetr_tpu_torch/csrc/nms.cu",
            "vdetr_tpu/geometry/nms.py:124 (jax.lax.while_loop in XLA, not "
            "a pallas_call)"),
}
PROBES = ("rpe_ablate", "dot_micro")
ROUTES = ("keyed", "mapped")
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
    "kernel_map": "27-offset neighbour lookup in sorted voxel keys: no "
                  "single torch op (searchsorted needs the packing, the "
                  "bounds check and the hit test around it)",
    "mapped_conv": "gather-GEMM over a neighbour map with misses: no single "
                   "torch op (the gather-then-matmul yardstick is timed "
                   "beside it, 'gather_matmul_ms')",
    "mapped_conv_dw": "weight gradient of a gather-GEMM: no single torch op",
    "nms": "greedy same-class 3D NMS: no torch op runs it (torchvision's "
           "is a package of finished kernels, 2D, and not installed)",
}


def log(*args):
    print(*args, flush=True)


def _dominant(cases) -> str:
    """What bounds the case with the largest bound."""
    return max(cases, key=lambda c: c["bound_ms"])["bound_by"]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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

def level_grids(cfg, device, batch: int = 1):
    """The voxel levels of `batch` synthetic scenes at the published
    capacities: [raw 1 cm, stem, stage 1 .. 4]."""
    from vdetr_tpu_torch.ops.voxelize import downsample_grid, voxelize

    inp = synthetic_batch(cfg.num_points, batch, device)
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
    case (label, kernel A's args, a premasked dout, neighbour hits, the
    conv's neighbour map)."""
    from vdetr_tpu_torch.ops.map_kernel import neighbour_map

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
        nbr = neighbour_map(gi.keys, args[2], go.valid, gi.extent)
        hits = int((nbr < gi.capacity).sum())
        label = (f"{cin}->{cout} {'submanifold' if li == lo else 'stride-2'}"
                 f" V_in={gi.capacity} V={go.capacity} "
                 f"valid={int(go.valid.sum())}")
        out.append((label, args, dout, hits, nbr))
    return out


def tile_rows(nbr, capacity: int, rows: int = 64) -> int:
    """The (row, offset) products kernels A and H compute: all `rows` rows
    of a row tile for each offset with a hit in it."""
    B, K, V = nbr.shape
    hit = F.pad(nbr < capacity, (0, -V % rows)).reshape(B, K, -1, rows)
    return int(hit.any(-1).sum()) * rows


def check_conv_kernel(name, cases, kernel, plain, rel_tol, reason,
                      kargs_of, computed):
    """A conv kernel (A, D, H or I) against its plain version on each conv
    case, called on `kargs_of(case)`; per case the error, both times and
    the bound (each tensor argument read once, the result written once;
    2 * C_in * C_out flops per neighbour hit). Every one of these kernels
    multiplies on the tensor cores in split TF32, so its bound is the
    larger of the bytes and 3 x the flops over the TF32 rate, with the f32
    CUDA-core bound beside it (`bound_f32_ms`). `computed(case)`: the
    (row, offset) products the kernel computes, of which the hits are the
    `hit_share`."""
    errs, ms, plain_ms, bound, bound_f32, out_cases = [], 0.0, 0.0, 0.0, \
        0.0, []
    for case in cases:
        label, args, hits = case[0], case[1], case[3]
        kargs = kargs_of(case)
        got = kernel(*kargs)
        ref = plain(*kargs)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        tol = rel_tol * max(1.0, scale)
        t_k = time_ms(lambda: kernel(*kargs), reps=10)
        t_p = time_ms(lambda: plain(*kargs), reps=3)
        cin, cout = args[5].shape[1:]
        io = (nbytes(*(a for a in kargs if torch.is_tensor(a)))
              + ref.numel() * 4)
        flops = 2.0 * cin * cout * hits
        f_ms, f_by = bound_ms(io, flops)
        b_ms, b_by = bound_split_tf32_ms(io, flops)
        ok = err <= tol
        # the share of the computed products with a hit
        share = hits / computed(case)
        rec = {"case": label, "max_abs_err": err, "ms": t_k,
               "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
               "tflops": flops / t_k * 1e-9, "hit_share": share,
               "bound_f32_ms": f_ms, "bound_f32_by": f_by}
        log(f"check {name} {label}: max_abs_err={err:.3e} "
            f"(max|ref|={scale:.3e}) tol={tol:.3e} -> "
            f"{'ok' if ok else 'FAIL'}; kernel {t_k:.4f} ms "
            f"({rec['tflops']:.1f} TFLOP/s), plain {t_p:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, split TF32 on the tensor cores; f32 "
            f"CUDA cores {f_ms:.4f} ms, {f_by}; {100 * share:.1f}% of the "
            "computed products have a neighbour)")
        errs.append((err, ok))
        ms += t_k
        plain_ms += t_p
        bound += b_ms
        bound_f32 += f_ms
        out_cases.append(rec)
    log("  tolerance reason: " + reason)
    return dict(ok=all(ok for _, ok in errs), err=max(e for e, _ in errs),
                ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=_dominant(out_cases), cases=out_cases,
                bound_f32_ms=bound_f32,
                bound_note="bound_ms: split TF32 on the tensor cores (3 x "
                           "flops / 495 TFLOP/s against bytes / 3.35 TB/s);"
                           " bound_f32_ms: flops / 67 TFLOP/s on the CUDA "
                           "cores")


CONV_REASON = ("float32 sums of up to 27*C_in products taken in another "
               "order than the plain per-offset matmuls, each product in "
               "split TF32 (hi*hi + hi*lo + lo*hi, ~2^-21 relative); the "
               "split's emulation stays within ~3e-3 of 1e-4 of max|ref| "
               "at n = 27*512 (tests/test_torch_kernel_premises.py), one "
               "TF32 pass ~3x over it")
DW_REASON = ("each dW entry is a float32 sum over up to 65536 rows, each "
             "product in split TF32 (hi*hi + hi*lo + lo*hi), 32-row stages "
             "summed apart and added in f32, then a fixed-order sum of row "
             "splits, against the plain version's GEMM order; the split's "
             "emulation stays within 0.1 of 2e-5 of max|ref| at 65536 rows "
             "(tests/test_torch_kernel_premises.py), one TF32 pass more than "
             "10x over 2e-5")


def conv_tile_rows(case) -> int:
    """The (row, offset) products kernels A and H compute on a case."""
    return tile_rows(case[4], case[1][0].shape[1])


def dw_rows(case) -> int:
    """The (row, offset) products kernels D and I compute on a case: in the
    dense form every row for all 27 offsets, else each offset's hits from
    the rulebook, a split's last stage of 32 rows padded."""
    from vdetr_tpu_torch.ops.sparse_conv_kernel import (
        dw_dense, dw_row_splits, dw_rulebook)

    nbr, (feats, *_, w) = case[4], case[1]
    B, _, V = nbr.shape
    C, Co = w.shape[1:]
    splits, per = dw_row_splits(B * V, C, Co)
    if dw_dense(C):
        rows = torch.clamp(B * V - per * torch.arange(splits), 0, per)
    else:
        rows = dw_rulebook(nbr, feats.shape[1], splits, per)[2].long()
    return int(((rows + 31) // 32).sum()) * 32 * (27 if dw_dense(C) else 1)


def check_keyed_conv(cases):
    from vdetr_tpu_torch.ops.sparse_conv_keyed import (keyed_conv,
                                                       keyed_conv_plain)

    return check_conv_kernel("keyed_conv", cases, keyed_conv,
                             keyed_conv_plain, 1e-4, CONV_REASON,
                             lambda c: c[1], conv_tile_rows)


def check_keyed_conv_dw(cases):
    from vdetr_tpu_torch.ops.sparse_conv_keyed import (keyed_conv_dw,
                                                       keyed_conv_dw_plain)

    return check_conv_kernel("keyed_conv_dw", cases, keyed_conv_dw,
                             keyed_conv_dw_plain, 2e-5, DW_REASON,
                             lambda c: c[1][:5] + (c[2],), dw_rows)


def gather_matmul(feats, nbr, weights):
    """The yardstick beside kernel H: all 27 neighbours gathered into one
    (B, V, 27 * C) tensor, then one torch.matmul with the (27 * C, Co)
    weights (TF32 off)."""
    from vdetr_tpu_torch.ops.voxelize import gather_rows

    B, _, V = nbr.shape
    x = gather_rows(feats, nbr.long().transpose(1, 2).reshape(B, V * 27))
    return torch.matmul(x.reshape(B, V, -1),
                        weights.reshape(-1, weights.shape[-1]))


def check_mapped_conv(cases):
    """Kernel H against its plain version, against kernel A on the same
    case (A's tolerance), and the gather-then-matmul yardstick's time."""
    from vdetr_tpu_torch.ops.sparse_conv_keyed import keyed_conv
    from vdetr_tpu_torch.ops.sparse_conv_kernel import (mapped_conv,
                                                        mapped_conv_plain)

    res = check_conv_kernel("mapped_conv", cases, mapped_conv,
                            mapped_conv_plain, 1e-4, CONV_REASON,
                            lambda c: (c[1][0], c[4], c[1][5]),
                            conv_tile_rows)
    worst_a, yard_ms = 0.0, 0.0
    for case, rec in zip(cases, res["cases"]):
        label, args, nbr = case[0], case[1], case[4]
        got = mapped_conv(args[0], nbr, args[5])
        ref = keyed_conv(*args)
        y = gather_matmul(args[0], nbr, args[5])
        torch.cuda.synchronize()
        scale = max(1.0, float(ref.abs().max()))
        err_a = float((got - ref).abs().max())
        err_y = float((y - got).abs().max())
        worst_a = max(worst_a, err_a / scale)
        t_y = time_ms(lambda: gather_matmul(args[0], nbr, args[5]), reps=3)
        yard_ms += t_y
        same = bool(torch.equal(got, ref))
        rec.update(vs_keyed_err=err_a, vs_keyed_bit_equal=same,
                   gather_matmul_ms=t_y)
        log(f"check mapped_conv vs keyed_conv {label}: max_abs_err="
            f"{err_a:.3e} (bit-equal: {same}) tol={1e-4 * scale:.3e} -> "
            f"{'ok' if err_a <= 1e-4 * scale else 'FAIL'}; gather-then-"
            f"matmul yardstick {t_y:.3f} ms (its max_abs_err vs H "
            f"{err_y:.3e})")
        del y
    res["ok"] = res["ok"] and worst_a <= 1e-4
    res["gather_matmul_ms"] = yard_ms
    return res


def check_mapped_conv_dw(cases):
    """Kernel I against its plain version, then, per case, bit for bit
    against kernel D on the same neighbours and against a second call of
    itself (D too): no atomics, a fixed order of sums."""
    from vdetr_tpu_torch.ops.sparse_conv_keyed import keyed_conv_dw
    from vdetr_tpu_torch.ops.sparse_conv_kernel import (mapped_conv_dw,
                                                        mapped_conv_dw_plain)

    res = check_conv_kernel("mapped_conv_dw", cases, mapped_conv_dw,
                            mapped_conv_dw_plain, 2e-5, DW_REASON,
                            lambda c: (c[1][0], c[4], c[2]), dw_rows)
    for case, rec in zip(cases, res["cases"]):
        label, args, dout, nbr = case[0], case[1], case[2], case[4]
        got = [mapped_conv_dw(args[0], nbr, dout) for _ in range(2)]
        ref = [keyed_conv_dw(*args[:5], dout) for _ in range(2)]
        same = {"I vs D": torch.equal(got[0], ref[0]),
                "I twice": torch.equal(got[0], got[1]),
                "D twice": torch.equal(ref[0], ref[1])}
        rec.update(bit_equal=same)
        res["ok"] &= all(same.values())
        log(f"check mapped_conv_dw {label}: bit-equal "
            + ", ".join(f"{k} {v}" for k, v in same.items())
            + f" -> {'ok' if all(same.values()) else 'FAIL'}")
        del got, ref
    return res


def map_cases(grids):
    """The nine neighbour maps of the published forward: the five
    stride-2 maps (raw -> stem, stem -> stage 1, ..., stage 3 -> 4; the
    queries are 2 * the coarser level's coords) and the four level maps
    (stages 1 .. 4 on their own sites). Per map (label, kernel G's
    args)."""
    out = []
    for li in range(len(grids) - 1):
        gi, go = grids[li], grids[li + 1]
        out.append((f"stride-2 V_in={gi.capacity} V={go.capacity}",
                    (gi.keys, (go.coords * 2).contiguous(), go.valid,
                     gi.extent)))
    for g in grids[2:]:
        out.append((f"level V={g.capacity}",
                    (g.keys, g.coords, g.valid, g.extent)))
    return out


def check_kernel_map(cfg, grids):
    """Kernel G against its plain version on the forward's nine maps at B =
    1 and B = 4, bit for bit: each map by `kernel_map` alone, and as the
    mapped forward launches them (the stem's stride-2 map alone, each
    stage's stride-2 and level maps in one `kernel_map_pair` launch).
    Per map at B = 1: both times and the bound (the keys, queries and
    validity read once, the map written once; the operations, per valid
    query row and (dx, dy) group a binary search of log2(V_in) steps and
    three compares, are far below it). Then the forward's set of launches
    (`tools/ab_kernels.py:measure_maps`): ms for the set by CUDA events,
    device us per launch and the gaps between launches (torch.profiler)."""
    from vdetr_tpu_torch.ops.map_kernel import (kernel_map, kernel_map_pair,
                                                neighbour_map,
                                                neighbour_map_pair)
    from vdetr_tpu_torch.tools.ab_kernels import measure_maps

    ok_all, plain_ms, bound, out_cases = True, 0.0, 0.0, []
    for batch, g in ((1, grids), (4, level_grids(cfg, grids[0].keys.device,
                                                   4))):
        mism_pairs = 0
        for fine, coarse in zip(g[1:-1], g[2:]):
            pargs = (fine.keys, fine.extent, coarse.keys, coarse.coords,
                     coarse.valid, coarse.extent)
            for got, ref in zip(kernel_map_pair(*pargs),
                                neighbour_map_pair(*pargs)):
                mism_pairs += int((got != ref).sum())
        ok_all &= mism_pairs == 0
        for label, args in map_cases(g):
            got = kernel_map(*args)
            ref = neighbour_map(*args)
            torch.cuda.synchronize()
            mism = int((got != ref).sum())
            ok = mism == 0
            ok_all &= ok
            keys, q, qv, _ = args
            line = (f"check kernel_map B={batch} {label} valid="
                    f"{int(qv.sum())}: {mism} entries differ, tolerance 0 -> "
                    f"{'ok' if ok else 'FAIL'}")
            if batch == 1:
                t_k = time_ms(lambda: kernel_map(*args), reps=10)
                t_p = time_ms(lambda: neighbour_map(*args), reps=3)
                ops = int(qv.sum()) * 9 * (math.log2(keys.shape[1]) + 3)
                b_ms, b_by = bound_ms(nbytes(keys, q, qv) + got.numel() * 4,
                                      ops)
                line += (f"; kernel {t_k:.4f} ms (one launch alone), plain "
                         f"{t_p:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
                plain_ms += t_p
                bound += b_ms
                out_cases.append({"case": label, "max_abs_err": float(mism),
                                  "ms": t_k, "plain_ms": t_p,
                                  "bound_ms": b_ms, "bound_by": b_by})
            log(line)
        log(f"check kernel_map B={batch} the four stages' pair launches: "
            f"{mism_pairs} entries differ, tolerance 0 -> "
            f"{'ok' if mism_pairs == 0 else 'FAIL'}")
    maps = measure_maps(cfg, grids[0].keys.device, sys.modules[__name__])
    for batch, m in maps.items():
        log(f"kernel_map the mapped forward's {m['launches']} launches, B="
            f"{batch}: {m['event_ms']:.4f} ms a set by CUDA events; device "
            f"{m['device_us_sum']:.1f} us in all ("
            + ", ".join(f"{us:.1f}" for us in m["device_us_per_launch"])
            + f" us a launch), mean gap between launches "
            f"{m['gap_us_mean']:.1f} us, device span {m['span_us']:.1f} us; "
            f"card {card()}")
    return dict(ok=ok_all, err=max(c["max_abs_err"] for c in out_cases),
                ms=maps["1"]["event_ms"], plain_ms=plain_ms, bound_ms=bound,
                bound_by=_dominant(out_cases), cases=out_cases,
                forward_maps=maps,
                ms_note="ms: the mapped forward's map launches as a set at "
                        "B=1 (CUDA events), plain_ms and bound_ms: the nine "
                        "maps' sums")


def fps_input(grids):
    """FPS's input on the main path: the stride-4 level's voxel centres,
    zeroed where invalid (B, 32768, 3 at the published capacities)."""
    level = grids[2]
    return (level.world_xyz() * level.valid[..., None]).contiguous()


def check_fps(cfg, grids):
    """Kernel B on one scene (B = 1) and on the four rows of an eval batch
    (B = 4), each against the plain version (tolerance 0), with ns a
    step, the roofline bound and the exchange floor (the same form with
    the pass over the points left out) side by side."""
    from vdetr_tpu_torch.ops.fps import (CLUSTER, THREADS, TRANSPORT,
                                         fps_launch, fps_plain,
                                         furthest_point_sample)

    npoint = cfg.preenc_npoints
    steps = npoint - 1
    cases, ok_all = [], True
    for batch, g in ((1, grids), (4, level_grids(cfg, grids[0].keys.device,
                                                   4))):
        xyz = fps_input(g)
        got = furthest_point_sample(xyz, npoint)
        t0 = time.perf_counter()
        ref = fps_plain(xyz, npoint)
        torch.cuda.synchronize()
        t_p = (time.perf_counter() - t0) * 1e3
        mism = int((got != ref).sum())
        ok = mism == 0
        ok_all &= ok
        t_k = time_ms(lambda: furthest_point_sample(xyz, npoint), reps=5)
        t_f = time_ms(lambda: fps_launch(xyz, npoint, floor=True), reps=5)
        # per step and point: 3 differences, a product and two fused
        # multiply-adds, a min and a compare: 10 flops
        n = xyz.shape[0] * xyz.shape[1]
        b_ms, b_by = bound_ms(nbytes(xyz) + got.numel() * 8,
                              10.0 * n * npoint)
        valid = int(g[2].valid.sum())
        log(f"check fps B={batch} N={xyz.shape[1]} (valid={valid}) "
            f"npoint={npoint}, form {CLUSTER} CTAs x {THREADS} threads, "
            f"{TRANSPORT}: {mism} indices differ, tolerance 0 (both round "
            f"fma(dz,dz,fma(dy,dy,dx*dx)) exactly) -> "
            f"{'ok' if ok else 'FAIL'}; kernel {t_k:.3f} ms = "
            f"{t_k * 1e6 / steps:.0f} ns a step; exchange floor {t_f:.3f} "
            f"ms = {t_f * 1e6 / steps:.0f} ns a step; bound {b_ms:.4f} ms "
            f"({b_by}) = {b_ms * 1e6 / steps:.1f} ns a step; plain "
            f"{t_p:.1f} ms (one timed call)")
        cases.append({"case": f"B={batch}", "max_abs_err": float(
            (got - ref).abs().max()), "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": b_by, "exchange_floor_ms": t_f,
            "ns_per_step": t_k * 1e6 / steps,
            "floor_ns_per_step": t_f * 1e6 / steps})
    one = cases[0]
    return dict(ok=ok_all, err=max(c["max_abs_err"] for c in cases),
                ms=one["ms"], plain_ms=one["plain_ms"],
                bound_ms=one["bound_ms"], bound_by=one["bound_by"],
                exchange_floor_ms=one["exchange_floor_ms"], cases=cases)


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


def rpe_bound(case, train: bool, backward: bool = False,
              tensor_core_products: bool = False):
    """Bytes each input and output once; flops as the ablation's
    `attention_flops` counts them for its level 6, kernel C (8 taps per
    corner; backward: the dO.V and ds.K products replace q.k and p.v, and
    the taps are dTables' multiply-adds). `tensor_core_products`: the two
    products (4 hd flops a head and pair) on the tensor cores in split
    TF32 (3 x over 495 TFLOP/s), the rest on the f32 CUDA cores, the two
    pipes overlapping (the larger of the two times)."""
    from vdetr_tpu_torch.tools.rpe_ablate import attention_flops

    q, k, v, corners, angles, key_xyz, tables, key_valid = case
    B, nQ, H, hd = q.shape
    nK = k.shape[1]
    pairs = B * nQ * nK
    flops = attention_flops(pairs, H, hd, taps=8)
    score_bytes = pairs * H * 4  # one (B, H, nQ, nK) f32 tensor
    if backward:  # reads logits, writes ds and eg; dq, dtables out
        io = (nbytes(k, v, corners, key_xyz, key_valid) + 2 * nbytes(q)
              + 3 * score_bytes + nbytes(q, tables))
    else:
        io = nbytes(*case) + nbytes(q)
        if train:
            io += score_bytes + B * nQ * H * 4
    if tensor_core_products:
        products = pairs * H * 4 * hd
        t_ops = max(3 * products / PEAK_TF32_FLOPS,
                    (flops - products) / PEAK_F32_FLOPS) * 1e3
        t_bytes = io / PEAK_BYTES * 1e3
        return ((t_bytes, "bytes") if t_bytes >= t_ops
                else (t_ops, "operations"))
    return bound_ms(io, flops)


def pair_work(case):
    """(bytes, flops) of F's pair kernel alone: the logits read once, ds
    and eg written once, K, V, the key mask, dO, O and lse read and dq
    written once; dp = dO V^T and dQ = ds K, 2 flops a multiply-add."""
    q, k, v, corners, angles, key_xyz, tables, key_valid = case
    B, nQ, H, hd = q.shape
    nK = k.shape[1]
    io = (3 * B * H * nQ * nK * 4 + nbytes(k, v, key_valid) + 3 * nbytes(q)
          + B * nQ * H * 4)
    return io, 2 * 2.0 * B * nQ * H * nK * hd


def sass_counts(name: str, kernel: str, instance: str = "ILi64E"):
    """{"hmma": n, "atomics": n, "global_atomics": n, "shared_atomics": n,
    "shared_cas": n}: the tensor-core MMA and the atomic instructions
    (RED, ATOM, ATOMG global; ATOMS shared, of which the compare-and-swap
    loops ATOMS.CAS*) in the SASS of `kernel`'s `instance` (the mangled
    template argument; default head width 64; "" for any) in kernel
    library `name`, read with cuobjdump; None without cuobjdump."""
    import re
    import subprocess
    from pathlib import Path

    from vdetr_tpu_torch import kernels

    try:
        tool = Path(kernels.nvcc_path()).parent / "cuobjdump"
    except RuntimeError:  # no CUDA toolkit
        return None
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(kernels._lib_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = {"hmma": 0, "atomics": 0, "global_atomics": 0,
              "shared_atomics": 0, "shared_cas": 0}
    inside = False
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            inside = kernel in fn.group(1) and instance in fn.group(1)
            continue
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if not (inside and op):
            continue
        base = op.group(1).split(".")[0]
        if base == "HMMA":
            counts["hmma"] += 1
        elif base in ("RED", "ATOM", "ATOMG", "ATOMS"):
            counts["atomics"] += 1
            if base == "ATOMS":
                counts["shared_atomics"] += 1
                counts["shared_cas"] += ".CAS" in op.group(1)
            else:
                counts["global_atomics"] += 1
    return counts


def ptxas_usage(name: str, kernel: str) -> dict:
    """{template argument: {"registers", "stack", "spill_stores",
    "spill_loads"}} of `kernel`'s instances in kernel library `name`, read
    from ptxas's report in its build log (`kernels.build_log`); empty if
    the library was not built in this run."""
    import re

    from vdetr_tpu_torch import kernels

    usage, current = {}, None
    for line in kernels.build_log(name).splitlines():
        fn = re.search(r"(?:entry function '|Function properties for )"
                       r"(\w+)", line)
        if fn:
            inst = re.search(r"ILi(\d+)E", fn.group(1))
            current = (usage.setdefault(int(inst.group(1)), {})
                       if kernel in fn.group(1) and inst else None)
            continue
        if current is None:
            continue
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers")):
            m = re.search(pat, line)
            if m:
                current[key] = int(m.group(1))
    return usage


def pair_products_ms(case, dout, ds, reps: int = 10) -> float:
    """A yardstick for F's pair kernel, not the same function: its two
    products alone, dp = dO V^T and dQ = ds K, as two torch.matmul calls
    with TF32 off (cuBLAS); the softmax, dropout and ds elementwise work
    is left out, so this bounds the kernel from below as cuBLAS does the
    products."""
    k, v = case[1], case[2]
    do = dout.permute(0, 2, 1, 3).contiguous()  # (B, H, nQ, hd)
    vt = v.transpose(1, 2).contiguous()[:, None]  # (B, 1, hd, nK)
    kk = k[:, None]

    def run():
        torch.matmul(do, vt)
        torch.matmul(ds, kk)

    return time_ms(run, reps=reps)


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
    plain training forward's logits and lse; its dq, dtables, ds and eg
    bit for bit from a second launch; the pair kernel's SASS (tensor-core
    MMAs, no atomics) and the table kernel's (no global atomic, no shared
    compare-and-swap loop); the bounds of F, its pair kernel and its
    table kernel; the pair kernel's two products as torch.matmul."""
    from vdetr_tpu_torch.ops.rpe_attention import (
        rpe_cross_attention_bwd, rpe_cross_attention_bwd_plain,
        rpe_cross_attention_plain)
    from vdetr_tpu_torch.tools.ab_kernels import profile_by_kernel

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
        again = rpe_cross_attention_bwd(*args, **fkw)
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
        same = {name: bool(torch.equal(got[i], again[i]))
                for i, name in enumerate(("dq", "dtables", "ds", "eg"))}
        ok_all &= all(same.values())
        t_k = time_ms(lambda: rpe_cross_attention_bwd(*args, **fkw), reps=5)
        t_p = time_ms(lambda: rpe_cross_attention_bwd_plain(*args, **fkw),
                      reps=2)
        parts_ms = {k: ms for k, (ms, _) in profile_by_kernel(
            lambda: rpe_cross_attention_bwd(*args, **fkw), reps=5).items()}
        lib_ms = pair_products_ms(case, dout, got[2])
        times[rate] = (t_k, t_p, parts_ms, lib_ms)
        log(f"check rpe_cross_attention_bwd dropout={rate}: "
            + "; ".join(parts) + f" -> {'ok' if ok_all else 'FAIL'}; "
            "a second launch bit for bit: "
            + ", ".join(f"{nm} {'equal' if eq else 'DIFFERS'}"
                        for nm, eq in same.items())
            + f"; kernel {t_k:.3f} ms (device ms per call, torch.profiler: "
            + ", ".join(f"{kn} {v:.4f}" for kn, v in parts_ms.items())
            + f"), plain {t_p:.3f} ms; the pair kernel's two products as "
            f"torch.matmul (TF32 off) {lib_ms:.4f} ms")
        del got, again, ref, out, lse, logits
    log(f"  the table kernel's items: a warp's 32 keys of one query fall in "
        f"{distinct_cells(cfg, case):.1f} distinct lower tap cells of a "
        "corner on average (first 64 queries, all corners)")
    b_ms, b_by = rpe_bound(case, train=True, backward=True,
                           tensor_core_products=True)
    f32_ms, f32_by = rpe_bound(case, train=True, backward=True)
    pio, pflops = pair_work(case)
    pb_ms, pb_by = bound_split_tf32_ms(pio, pflops)
    pf_ms, _ = bound_ms(pio, pflops)
    # the table kernel alone: ds, the corners, key positions and mask read
    # once, dtables written once; 8 corners x 8 taps x H multiply-adds a
    # pair
    B, nK, H = q.shape[0], k.shape[1], q.shape[2]
    tb_ms, tb_by = bound_ms(
        nbytes(corners, key_xyz, key_valid, tables)
        + B * H * q.shape[1] * nK * 4, B * q.shape[1] * nK * 8 * 8 * H * 2.0)
    sass = sass_counts("rpe_attention_bwd", "rpe_pair_bwd_kernel")
    if sass is not None:
        ok_all &= sass["hmma"] > 0 and sass["atomics"] == 0
    table_sass = sass_counts("rpe_attention_bwd", "rpe_table_bwd_kernel", "")
    if table_sass is not None:
        ok_all &= (table_sass["global_atomics"] == 0
                   and table_sass["shared_cas"] == 0
                   and table_sass["shared_atomics"] > 0)
    ptxas = ptxas_usage("rpe_attention_bwd", "rpe_pair_bwd_kernel")
    log(f"  bound {b_ms:.4f} ms ({b_by}; the products on the tensor cores in "
        f"split TF32; all f32 on the CUDA cores {f32_ms:.4f} ms, {f32_by}); "
        f"the pair kernel's own bound {pb_ms:.4f} ms ({pb_by}: bytes "
        f"{pio / PEAK_BYTES * 1e3:.4f} ms, split-TF32 operations "
        f"{3 * pflops / PEAK_TF32_FLOPS * 1e3:.4f} ms, f32 operations "
        f"{pflops / PEAK_F32_FLOPS * 1e3:.4f} ms); the table kernel's own "
        f"bound {tb_ms:.4f} ms ({tb_by}); the pair kernel's SASS at head "
        "width 64: " + ("not measured (no cuobjdump)" if sass is None else
                  f"{sass['hmma']} HMMA, {sass['atomics']} atomic "
                  "instructions")
        + "; the table kernel's SASS: " + (
            "not measured (no cuobjdump)" if table_sass is None else
            f"{table_sass['shared_atomics']} shared atomics, of them "
            f"{table_sass['shared_cas']} compare-and-swap, "
            f"{table_sass['global_atomics']} global atomics")
        + "; its ptxas report per head width: " + (", ".join(
            f"{hd}: {u.get('registers')} registers, {u.get('stack')} B "
            f"stack, {u.get('spill_stores')} B spill stores, "
            f"{u.get('spill_loads')} B spill loads"
            for hd, u in sorted(ptxas.items())) or "not read (not built in "
            "this run)")
        + "; tolerance reason: dq sums 4096 keys in split TF32 (three TF32 "
        "MMAs per f32 product, each stage summed from 0, the key shares "
        "added in a fixed order); dtables sums ~4M pairs in 64-bit fixed "
        "point per block (each term rounded to 2^-30 of max|ds|), each "
        "block's table rounded to f32 once and the slices added in f32 in "
        "order, against the plain version's f32 index_add_: ~1e-6 relative "
        "per term; 1e-4 of max|ref| leaves ~10x margin over the spread "
        "measured on the card")
    t_k, t_p, parts_ms, lib_ms = times[0.1]
    return dict(ok=ok_all, err=worst, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, bound_f32_ms=f32_ms,
                bound_note="bound_ms: the dp and dQ products on the tensor "
                           "cores in split TF32 (3 x flops / 495 TFLOP/s), "
                           "the softmax and dTables work on the f32 CUDA "
                           "cores, overlapping, against the bytes; "
                           "bound_f32_ms: every flop / 67 TFLOP/s",
                library_ms=lib_ms,
                library="yardstick, not the same function: the pair "
                        "kernel's two products (dp = dO V^T, dQ = ds K) as "
                        "two torch.matmul calls with TF32 off, the "
                        "elementwise work and the table kernel left out",
                ms_dropout0=times[0.0][0],
                pair_ms=parts_ms.get("F pair"),
                pair_ms_dropout0=times[0.0][2].get("F pair"),
                dq_sum_ms=parts_ms.get("F dq sum"),
                table_ms=parts_ms.get("F table"),
                pair_bound_ms=pb_ms, pair_bound_by=pb_by,
                pair_bound_f32_ms=pf_ms, pair_sass=sass,
                table_sass=table_sass, table_sum_ms=parts_ms.get(
                    "F table sum"),
                pair_ptxas={str(hd): u for hd, u in sorted(ptxas.items())},
                table_bound_ms=tb_ms, table_bound_by=tb_by)


def check_rpe_table_sum(cfg, device, gen):
    """The sum of F's table slices at the published shape (B = 1: 32
    query tiles x the table kernel's key shares, `table_key_split`)
    against its plain version, which adds in the same order: bit for bit.
    Bound: the slices read once and dtables written once. Yardstick: one
    `torch.sum(slices, 0)`, the same function in its own order. Both
    timed by CUDA events around the calls, host-bound at this size
    (device times: `tools/ab_kernels.py:measure_table_sum`)."""
    from vdetr_tpu_torch.ops.rpe_attention import (rpe_table_sum,
                                                   rpe_table_sum_plain,
                                                   table_key_split)

    nQ, nK, H, n = (cfg.nqueries, cfg.preenc_npoints, cfg.dec_nhead,
                    cfg.rpe_table_size)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    count = -(-nQ // 32) * table_key_split(1, nQ, nK, sms)[1]
    slices = torch.randn(count, 8, n, n, n, H, generator=gen, device=device)
    got = rpe_table_sum(slices)
    ref = rpe_table_sum_plain(slices)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, ref))
    t_k = time_ms(lambda: rpe_table_sum(slices), reps=20)
    t_p = time_ms(lambda: rpe_table_sum_plain(slices), reps=5)
    t_l = time_ms(lambda: torch.sum(slices, 0), reps=20)
    b_ms, b_by = bound_ms(nbytes(slices, got), count * got.numel())
    log(f"check rpe_table_sum {count} slices of (8, {n}, {n}, {n}, {H}): "
        f"bit-equal to the plain sum in slice order: {same} -> "
        f"{'ok' if same else 'FAIL'}; kernel {t_k:.4f} ms, plain {t_p:.4f} "
        f"ms, torch.sum(slices, 0) {t_l:.4f} ms (CUDA events, host-bound), "
        f"bound {b_ms:.4f} ms ({b_by})")
    return dict(ok=same, err=float((got - ref).abs().max()), ms=t_k,
                plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l,
                library="torch.sum(slices, 0): the same sum in its own order",
                slices=count,
                ms_note="CUDA events around the calls, host-bound at this "
                        "size; device times: tools/ab_kernels.py")


def distinct_cells(cfg, case, queries: int = 64) -> float:
    """Mean count of distinct lower tap cells among the 32 consecutive keys
    a warp of kernel F's table kernel takes, per query and corner (no
    rotation, as check_rpe_bwd runs it)."""
    from vdetr_tpu_torch.ops.rpe import log_quantize

    q, k, v, corners, angles, key_xyz, tables, key_valid = case
    n = tables.shape[1]
    d = corners[0, :queries, :, None, :] - key_xyz[0, None, None]
    idx = ((log_quantize(d, cfg.log_scale, cfg.rpe_max_value) + 1.0) * n
           - 1.0) * 0.5
    c = torch.floor(idx).long() + 1
    cell = ((c[..., 2] * 32 + c[..., 1]) * 32 + c[..., 0])
    cell = cell[..., : cell.shape[-1] // 32 * 32].reshape(-1, 32)
    cell = cell.sort(-1).values
    return float((cell[:, 1:] != cell[:, :-1]).sum(-1).add(1).float().mean())


# --------------------------------------------------------------------------
# phase 3b: the probes of kernel C
# --------------------------------------------------------------------------

def check_rpe_ablate(device, reps: int = 20):
    """The stage ablation at the tool's shapes and inputs: levels 0-5
    against the plain version (levels 1 and 2 also on coordinates scaled
    down, where their softmax is not saturated), level 6 bit-equal to C,
    then each level's time, stage cost and bound, and level 0's yardstick,
    SDPA at scale 1."""
    from vdetr_tpu_torch.ops.rpe_attention import rpe_cross_attention
    from vdetr_tpu_torch.tools import rpe_ablate as tra

    inputs = tra.make_inputs(device=device)
    soft = {1: 0.05, 2: 3e-4}
    ok, errs, plain_ms = True, {}, {}
    for level in tra.LEVELS:
        got = tra.rpe_ablate(level, *inputs)
        if level == 6:
            q, k, v, corners, key_xyz, tables = inputs
            c_out = rpe_cross_attention(q, k, v, corners, None, key_xyz,
                                        tables, None, log_scale=tra.LOG_SCALE,
                                        max_value=tra.MAX_VALUE)
            same = bool(torch.equal(got, c_out))
            ok &= same
        ref = tra.rpe_ablate_plain(level, *inputs)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = tra.rounding_tol(level, *inputs)
        max_logit, margin, rounding = tra.logit_stats(level, *inputs)
        good = err <= tol
        line = (f"check rpe_ablate level {level}: max_abs_err={err:.3e} "
                f"tol={tol:.3e} (max|logit| {max_logit:.1f}, min top-2 "
                f"margin {margin:.2e} against the logit rounding allowance "
                f"{rounding:.1e})")
        if level == 6:
            line += f"; bit-equal to kernel C: {same}"
        if level in soft:
            sin = tra.make_inputs(device=device, scale=soft[level])
            s_err = float((tra.rpe_ablate(level, *sin)
                           - tra.rpe_ablate_plain(level, *sin)).abs().max())
            s_tol = tra.rounding_tol(level, *sin)
            good &= s_err <= s_tol
            line += (f"; coordinates x{soft[level]:g} max_abs_err "
                     f"{s_err:.3e} tol {s_tol:.3e}")
            del sin
        ok &= good
        log(line + f" -> {'ok' if good else 'FAIL'}")
        errs[level] = err
        plain_ms[level] = time_ms(
            lambda: tra.rpe_ablate_plain(level, *inputs), reps=3)
    log("  tolerance reason: softmax is 1/2-Lipschitz from the logits' max "
        "norm to the probabilities' 1-norm, so |d out| <= 2 max|v| max|d "
        "logit| whatever the top-2 margin, so a near tie below the "
        "rounding allowance (16 ulps of max(1, max|logit|)) amplifies "
        "nothing; levels 1 and 2 saturate at the tool's coordinates, hence "
        "their second, scaled-down input")
    rows = tra.run_levels(inputs, reps)
    log(f"rpe_ablate stage decomposition of kernel C, B {tra.B}, nQ "
        f"{tra.NQ}, nK {tra.NK}, H {tra.H}, hd {tra.HD}, n {tra.N}, no mask,"
        f" mean of {reps} launches; stage = ms - the previous level's, for "
        f"the nested levels 1-5 only; card {card()}:")
    for line in tra.format_rows(rows):
        log("  " + line)
    # level 0's yardstick: f32 SDPA at scale 1 (TF32 off), timed apart
    lay = tra.sdpa_layout(*inputs[:3])
    sdpa_err = float((tra.flash_library(*lay).transpose(1, 2)
                      - tra.rpe_ablate(0, *inputs)).abs().max())
    sdpa_ms = time_ms(lambda: tra.flash_library(*lay), reps)
    log(f"  level 0 yardstick F.scaled_dot_product_attention (f32, scale 1, "
        f"heads on dim 1, K and V expanded beforehand): {sdpa_ms:.4f} ms, "
        f"max |SDPA - level 0 kernel| {sdpa_err:.3e}")
    del lay
    cases = [dict(case=r["label"], max_abs_err=errs[r["level"]], ms=r["ms"],
                  stage_ms=r["stage_ms"], plain_ms=plain_ms[r["level"]],
                  bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                  library_ms=sdpa_ms if r["level"] == 0 else None)
             for r in rows]
    cases[0]["library_max_abs_err"] = sdpa_err
    kernel_cases = cases[:6]  # level 6 is kernel C, reported as C
    return dict(ok=ok, err=max(errs[lv] for lv in range(6)),
                ms=sum(c["ms"] for c in kernel_cases),
                plain_ms=sum(c["plain_ms"] for c in kernel_cases),
                bound_ms=sum(c["bound_ms"] for c in kernel_cases),
                bound_by=_dominant(kernel_cases),
                library="per case: level 0 F.scaled_dot_product_attention(q,"
                        " k, v, scale=1.0) in f32, its case's library_ms; "
                        "levels 1-5 none: SDPA takes no such bias without "
                        "materializing it", cases=cases)


def check_dot_micro(device, reps: int = 20):
    """The table contraction on the tool's five variants and draws: the
    kernel against its plain version and the einsum (TF32 off), then
    their times and the einsum's with TF32 on."""
    from vdetr_tpu_torch.tools import dot_micro as tdm

    cases = tdm.make_inputs(device)
    ok, errs = True, []
    for label, T, P, _ in cases:
        got = tdm.dot_micro(T, P)
        ref = tdm.dot_micro_plain(T, P)
        lib = tdm.dot_micro_library(T, P)
        torch.cuda.synchronize()
        rtol = tdm.rounding_rtol(T)
        rel = max(float(((got - r).abs() / r.abs()).max()) for r in (ref, lib))
        err = max(float((got - r).abs().max()) for r in (ref, lib))
        good = rel <= rtol
        ok &= good
        errs.append(err)
        log(f"check dot_micro {label} nc={T.shape[0]}: max_abs_err={err:.3e}"
            f" (max|ref| {float(ref.abs().max()):.1f}), elementwise relative "
            f"{rel:.2e} tol {rtol:.2e} -> {'ok' if good else 'FAIL'}")
    log("  tolerance reason: every term is positive, so each float32 order "
        "of the nc K-term sum is within nc K 2^-24 of the exact sum, two "
        "orders within twice that, elementwise")
    rows = tdm.run_variants(cases, reps, device_times=False)
    log(f"dot_micro, mean of {reps} launches each (CUDA events); card "
        f"{card()}:")
    for line in tdm.format_rows(rows):
        log("  " + line)
    for row, err in zip(rows, errs):
        row["max_abs_err"] = err
    return dict(ok=ok, err=max(errs), ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r["bound_ms"] for r in rows),
                bound_by=_dominant(rows),
                library_ms=sum(r["library_ms"] for r in rows),
                library_tf32_ms=sum(r["library_tf32_ms"] for r in rows),
                library="torch.einsum('ckm,ke->me', T, P), TF32 off (it sums"
                        " T over the corners before its one GEMM); "
                        "library_tf32_ms: the same with TF32 on",
                ms_note="CUDA events around the calls, host-bound at these "
                        "sizes; device times: python -m "
                        "vdetr_tpu_torch.tools.dot_micro",
                cases=rows)


# --------------------------------------------------------------------------
# phase 4: the published forward
# --------------------------------------------------------------------------

def expected_launches(model, cfg, train: bool = False):
    """Kernel launches of one forward, or of one train step, on the
    model's conv route. Keyed: A once per 3^3 conv forward and again for
    each submanifold conv's dFeats, D once per 3^3 conv. Mapped: G once
    launch per stride-2 3^3 conv: the stem's map alone, and each stage's
    first block's stride-2 map with the level's own map in one launch
    (the maps are saved for the backward); H where keyed runs A, I where
    keyed runs D; no A or D. Both: C, and F with the sum of its table
    slices, once per decoder layer, FPS once. The probes (rpe_ablate,
    dot_micro) never."""
    from vdetr_tpu_torch.models.backbone import SparseConv, SparseConvDown

    k3 = [m for m in model.modules()
          if isinstance(m, (SparseConv, SparseConvDown))
          and m.kernel_size == 3]
    conv = sum(isinstance(m, SparseConv) for m in k3) if train else 0
    conv += len(k3)
    layers = cfg.dec_nlayers - 1
    out = {k: 0 for k in launch_counters()}
    out.update(fps=1, rpe_cross_attention=layers)
    if model.conv_route == "keyed":
        out["keyed_conv"] = conv
    else:
        out["kernel_map"] = sum(isinstance(m, SparseConvDown) for m in k3)
        out["mapped_conv"] = conv
    if train:
        out["keyed_conv_dw" if model.conv_route == "keyed"
            else "mapped_conv_dw"] = len(k3)
        out["rpe_cross_attention_bwd"] = layers
        out["rpe_table_sum"] = layers
    return out


def launch_counters():
    from vdetr_tpu_torch.geometry.nms import nms_3d_samecls_mask
    from vdetr_tpu_torch.ops.fps import furthest_point_sample
    from vdetr_tpu_torch.ops.map_kernel import kernel_map
    from vdetr_tpu_torch.ops.rpe_attention import (rpe_cross_attention,
                                                   rpe_cross_attention_bwd,
                                                   rpe_table_sum)
    from vdetr_tpu_torch.ops.sparse_conv_keyed import (keyed_conv,
                                                       keyed_conv_dw)
    from vdetr_tpu_torch.ops.sparse_conv_kernel import (mapped_conv,
                                                        mapped_conv_dw)
    from vdetr_tpu_torch.tools.dot_micro import dot_micro
    from vdetr_tpu_torch.tools.rpe_ablate import rpe_ablate

    return {"keyed_conv": keyed_conv, "fps": furthest_point_sample,
            "rpe_cross_attention": rpe_cross_attention,
            "keyed_conv_dw": keyed_conv_dw,
            "rpe_cross_attention_bwd": rpe_cross_attention_bwd,
            "rpe_table_sum": rpe_table_sum, "kernel_map": kernel_map, "mapped_conv": mapped_conv,
            "mapped_conv_dw": mapped_conv_dw, "rpe_ablate": rpe_ablate,
            "dot_micro": dot_micro, "nms": nms_3d_samecls_mask}


def fmt_counts(counts, expected):
    return ", ".join(f"{k} {counts[k]} (expected {e})"
                     for k, e in expected.items())


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


def published_model(cfg, device, route):
    """The published model on `route`, its weights from the seed (the
    same on both routes)."""
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.models.vdetr import build_model

    return build_model(cfg, ScannetDatasetConfig(),
                       generator=torch.Generator().manual_seed(SEED),
                       device=device, conv_route=route)


def run_forward(models, cfg, device, power, reps: int = 6):
    """The published forward of each route's model at batch 1 and 4:
    launches and outputs of one run, then `reps` timed runs per route, the
    routes in turn (the order alternating) so that their medians share
    the call's conditions; median ms per scene and peak memory (with both
    routes' models resident)."""
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig

    ds = ScannetDatasetConfig()
    counters = launch_counters()
    ok, launches = True, {route: None for route in models}
    per_batch = {route: {} for route in models}
    for B in (1, 4):
        inputs = synthetic_batch(cfg.num_points, B, device)
        times = {route: [] for route in models}
        with torch.inference_mode():
            for route, model in models.items():
                expected = expected_launches(model, cfg)
                for fn in counters.values():
                    fn.launches = 0
                out = model(inputs)
                torch.cuda.synchronize()
                counts = {k: fn.launches for k, fn in counters.items()}
                bad = check_outputs(out, cfg, B, ds.num_semcls)
                ok &= counts == expected and not bad
                if B == 1:
                    launches[route] = counts
                del out
                torch.cuda.reset_peak_memory_stats(device)
                model(inputs)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
                log(f"forward {route} B={B} N={cfg.num_points}: launches "
                    + fmt_counts(counts, expected)
                    + f"; outputs {'finite, shapes ok' if not bad else bad[:5]}"
                    f"; peak memory {peak:.2f} GiB (both routes' weights "
                    "resident)")
            for i in range(reps):
                for route in (ROUTES if i % 2 == 0 else ROUTES[::-1]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    models[route](inputs)
                    torch.cuda.synchronize()
                    times[route].append((time.perf_counter() - t0) * 1e3)
        for route in models:
            med = statistics.median(times[route])
            per_batch[route][B] = med / B
            runs = ", ".join(f"{t:.1f}" for t in times[route])
            log(f"forward {route} B={B}: median {med:.2f} ms "
                f"({med / B:.2f} ms/scene) over {reps} warm runs in turn with "
                f"the other route [{runs}]; card {power}")
    return ok, launches, per_batch


def tiny_config():
    from vdetr_tpu_torch.config import VDETRConfig

    return VDETRConfig(
        voxel_capacity=2048, min_stage_capacity=128,
        grid_extent=(128, 128, 64), preenc_npoints=128, nqueries=64,
        dec_nlayers=3, dec_dim=32, dec_ffn_dim=32, dec_nhead=4, rpe_dim=16,
        inplanes=8, enc_dim=32, num_points=512)


def compare_fpn(models, cfg, device):
    """The FPN output (the out block's features, `debug_stop=3`) of the two
    routes on the same weights and scene."""
    inputs = synthetic_batch(cfg.num_points, 1, device)
    feats = {}
    for route, model in models.items():
        block = getattr(model, f"out_block_{cfg.layer_idx}")
        hook = block.register_forward_hook(
            lambda mod, args, out, route=route: feats.__setitem__(
                route, out.features))
        with torch.inference_mode():
            model(inputs, debug_stop=3)
        hook.remove()
    torch.cuda.synchronize()
    ref, got = feats["keyed"], feats["mapped"]
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    tol = 1e-4 * max(1.0, scale)
    ok = err <= tol and bool(torch.isfinite(got).all())
    log(f"forward FPN output, mapped vs keyed route, B=1: max_abs_err="
        f"{err:.3e} (max|keyed|={scale:.3e}) tol={tol:.3e} -> "
        f"{'ok' if ok else 'FAIL'}")
    log("  tolerance reason: H and A run the same f32 tile GEMM over the "
        "same neighbours, so the routes differ only where a kernel's "
        "summation order does: A's 1e-4 of max|ref| per conv")
    return ok, err


def check_small_forward_against_cpu(device, gen, route):
    """The whole forward at a small size on `route`: kernels on the card
    against the plain versions on the CPU, same weights and inputs."""
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.models.vdetr import build_model

    cfg = tiny_config()
    model = build_model(cfg, ScannetDatasetConfig(), generator=gen,
                        device="cpu", conv_route=route)
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
    log(f"forward {route} small config on card vs CPU plain path: seeds "
        f"equal="
        f"{seeds_equal}, max_abs_err over final outputs={err:.3e} tol={tol:.0e}"
        f" (f32 rounding through ~40 layers) -> {'ok' if ok else 'FAIL'}")
    return ok


# --------------------------------------------------------------------------
# phase 4b: the eval step (scan in, boxes out) and its NMS kernel N
# --------------------------------------------------------------------------

# flops of one overlap test of kernel N: 6 min/max, 3 differences, 3
# clamps, 2 products, an add, a difference, a max, a quotient, the
# class select and the compare
NMS_TEST_FLOPS = 20


def eval_config(cfg):
    """The published eval step's config: `test_only` (empty-box removal
    on). The exact JV matcher is named only because the Trainer builds
    the criterion, which refuses the unported auction; the eval step
    never runs it."""
    return cfg.replace(test_only=True, matcher_impl="jv")


def nms_tests(aabbs, scores, classes, valid, thr):
    """The overlap tests the greedy loop does on these inputs: for each
    box it keeps, one against every other box still alive then (the plain
    loop replayed, counting)."""
    from vdetr_tpu_torch.geometry.nms import overlaps_samecls

    ov = overlaps_samecls(aabbs, classes)
    B, K = scores.shape
    ar = torch.arange(K, device=scores.device)
    neg = torch.tensor(-math.inf, device=scores.device)
    tests = 0
    for b in range(B):
        alive = valid[b].clone()
        while bool(alive.any()):
            i = torch.where(alive, scores[b], neg).argmax()
            tests += int(alive.sum()) - 1
            alive &= ~((ov[b, i] > thr) | (ar == i))
    return tests


def nms_kernel_ms(fn, reps: int = 5):
    """{"mask": ms, "scan": ms}: the device ms per call of kernel N's two
    kernels (torch.profiler, one session a call). A tree whose kernel N is
    one scan kernel reports it as "scan"."""
    from vdetr_tpu_torch.tools.ab_kernels import profiled_calls

    calls = profiled_calls(fn, reps, keep=lambda e: "nms_" in e.name)
    out = {}
    for call in calls:
        for kname, a, z in call:
            part = "mask" if "nms_mask" in kname else "scan"
            out[part] = out.get(part, 0.0) + (z - a) / 1e3 / len(calls)
    return out


def nms_mask_bytes(B, K):
    """The bytes kernel N's mask kernel writes: the upper triangle's
    64-bit words (64 rows a tile pair) and a seed word a tile."""
    W = -(-K // 64)
    return B * 8 * (64 * W * (W + 1) // 2 + W)


def check_nms_case(label, aabbs, scores, classes, valid, thr, reps=20):
    """Kernel N on one set of boxes against its plain loop (bit for bit),
    with the wrapper's time (the sort and kernel N's two launches, CUDA
    events), its mask and scan kernels' device times apart, the plain
    loop's time and the bound from this data's overlap tests (the mask's
    bytes beside it)."""
    from vdetr_tpu_torch.geometry.nms import (nms_3d_samecls_mask_plain,
                                              nms_launch)

    def run():
        return nms_launch(aabbs, scores, classes, valid, thr)

    got = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = nms_3d_samecls_mask_plain(aabbs, scores, classes, valid, thr)
    torch.cuda.synchronize()
    t_p = (time.perf_counter() - t0) * 1e3
    mism = int((got != ref).sum())
    t_k = time_ms(run, reps)
    dev = nms_kernel_ms(run)
    tests = nms_tests(aabbs, scores, classes, valid, thr)
    b_ms, b_by = bound_ms(nbytes(aabbs, scores, classes, valid, got),
                          NMS_TEST_FLOPS * tests)
    B, K = scores.shape
    ties = int(scores.numel() - sum(torch.unique(s).numel()
                                    for s in scores))
    mask_bytes = nms_mask_bytes(B, K)
    log(f"check nms {label} B={B} K={K}: {int(valid.sum())} valid, "
        f"{ties} tied scores, {int(got.sum())} kept, {tests} overlap tests; "
        f"{mism} keep flags differ from the plain loop, tolerance 0 (the "
        f"same f32 operations, each rounded alone) -> "
        f"{'ok' if mism == 0 else 'FAIL'}; wrapper {t_k:.4f} ms (sort and "
        f"two launches, CUDA events), mask kernel "
        f"{dev.get('mask', 0.0):.4f} device ms, scan kernel "
        f"{dev.get('scan', 0.0):.4f} device ms; bound {b_ms:.5f} ms "
        f"({b_by}; the mask's {mask_bytes} bytes at 3.35 TB/s: "
        f"{mask_bytes / 3.35e9:.5f} ms); plain loop {t_p:.1f} ms")
    return {"case": f"{label} B={B} K={K}", "ok": mism == 0,
            "max_abs_err": float(mism > 0), "ms": t_k,
            "device_ms": sum(dev.values()), "mask_ms": dev.get("mask"),
            "scan_ms": dev.get("scan"), "mask_bytes": mask_bytes,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "overlap_tests": tests, "kept": int(got.sum()),
            "tied_scores": ties}


def check_nms(device, captured, thr):
    """Kernel N against its plain loop on random boxes (exact score ties,
    pairs at overlap exactly 0.25, holes in `valid`: tools/nms_cases.py)
    at K = 1024, 1000 and 4097 for B = 1 and 4, on chains of boxes each
    killing the next (K = 1024, B = 1 and 4: the scan walks every tile in
    order), and on the NMS inputs of the published eval steps
    (`captured`: route, B and the wrapper's arguments). The record's
    numbers are the first case's (K = 1024, B = 1)."""
    from vdetr_tpu_torch.tools.nms_cases import nms_cases, nms_chain

    rng = np.random.RandomState(SEED)
    cases = []
    for K in (1024, 1000, 4097):
        for B in (1, 4):
            args = [torch.from_numpy(a).to(device)
                    for a in nms_cases(rng, B, K)]
            cases.append(check_nms_case("random", *args, thr))
    for B in (1, 4):  # every tile walked in order
        args = [torch.from_numpy(a).to(device)
                for a in nms_chain(rng, B, 1024)]
        cases.append(check_nms_case("chain", *args, thr))
    for route, B, (aabbs, scores, classes, valid, _) in captured:
        cases.append(check_nms_case(f"published eval outputs, {route}",
                                    aabbs, scores, classes, valid, thr))
    one = cases[0]
    return dict(ok=all(c["ok"] for c in cases),
                err=max(c["max_abs_err"] for c in cases), ms=one["ms"],
                plain_ms=one["plain_ms"], bound_ms=one["bound_ms"],
                bound_by=one["bound_by"], device_ms=one["device_ms"],
                mask_ms=one["mask_ms"], scan_ms=one["scan_ms"],
                mask_bytes=one["mask_bytes"], cases=cases)


def run_eval(models, cfg, device, power, reps: int = 6):
    """The published eval step (`Trainer.eval_step`, `test_only`) of each
    route's model at batch 1 and 4: its launches (the forward's and one of
    N), finite outputs, the boxes kept and the peak memory of one step,
    with the NMS inputs captured for `check_nms`; then `reps` timed runs
    of the whole step and of the forward alone, the routes in turn and
    step and forward alternating, median ms per scene of each and their
    difference (the sigmoid, empty-box removal and NMS)."""
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.train import engine

    ds = ScannetDatasetConfig()
    trainers = {route: engine.Trainer(cfg, m, ds, 1, device=device)
                for route, m in models.items()}
    counters = launch_counters()
    real_nms = engine.nms_3d_samecls_mask
    ok, launches, captured = True, {}, []
    per = {route: {} for route in models}
    for B in (1, 4):
        inputs = synthetic_batch(cfg.num_points, B, device)
        for route, tr in trainers.items():
            expected = expected_launches(tr.model, cfg)
            expected["nms"] = 1

            def capture(*args, route=route):
                captured.append((route, B, args))
                return real_nms(*args)

            engine.nms_3d_samecls_mask = capture
            for fn in counters.values():
                fn.launches = 0
            try:
                out = tr.eval_step(inputs)
                torch.cuda.synchronize()
            finally:
                engine.nms_3d_samecls_mask = real_nms
            counts = {k: fn.launches for k, fn in counters.items()}
            bad = [k for k, v in out.items()
                   if not bool(torch.isfinite(v.float()).all())]
            if tuple(out["nms_keep"].shape) != (B, cfg.nqueries):
                bad.append(f"nms_keep {tuple(out['nms_keep'].shape)}")
            kept = out["nms_keep"].sum(1).tolist()
            ok &= counts == expected and not bad and min(kept) > 0
            if B == 1:
                launches[route] = counts
            del out
            torch.cuda.reset_peak_memory_stats(device)
            tr.eval_step(inputs)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
            log(f"eval step {route} B={B} N={cfg.num_points}: launches "
                + fmt_counts(counts, expected)
                + f"; outputs {'finite, shapes ok' if not bad else bad[:5]}"
                f"; boxes kept per scene {kept} of {cfg.nqueries}; peak "
                f"memory {peak:.2f} GiB (both routes' weights resident)")
            per[route][B] = {"kept": kept, "peak_gib": peak}
        times = {(route, what): [] for route in models
                 for what in ("step", "forward")}
        for i in range(reps):
            for route in (ROUTES if i % 2 == 0 else ROUTES[::-1]):
                tr = trainers[route]

                def forward(model=tr.model):
                    with torch.inference_mode():
                        model(inputs)

                runs = (("step", lambda tr=tr: tr.eval_step(inputs)),
                        ("forward", forward))
                for what, fn in (runs if i % 2 == 0 else runs[::-1]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times[route, what].append(
                        (time.perf_counter() - t0) * 1e3)
        for route in models:
            step = statistics.median(times[route, "step"]) / B
            fwd = statistics.median(times[route, "forward"]) / B
            per[route][B].update(step_ms_per_scene=step,
                                 forward_ms_per_scene=fwd)
            log(f"eval step {route} B={B}: {step:.2f} ms/scene, forward "
                f"alone {fwd:.2f} ms/scene, the step's sigmoid, empty-box "
                f"removal and NMS {step - fwd:.2f} ms/scene (medians of "
                f"{reps} runs in turn with the other route, step and "
                "forward alternating; step "
                + ", ".join(f"{t:.1f}" for t in times[route, "step"])
                + "; forward "
                + ", ".join(f"{t:.1f}" for t in times[route, "forward"])
                + f" ms); card {power}")
        per["keyed"][B]["post_forward"] = eval_breakdown(trainers["keyed"],
                                                         inputs, power)
    return ok, launches, per, captured, trainers


def eval_breakdown(trainer, inputs, power):
    """Where the eval step's time above the forward goes, on one step's
    outputs: the empty-box removal (`Trainer._nonempty`: the subsample
    gather and the chunked points-in-boxes counts) and the whole device
    NMS (`_nms_keep`: the removal, the AABBs, the classes, the sort and
    kernel N), each by CUDA events around the call (the host's launch
    time included) and by the device's own time (`device_ms`)."""
    from vdetr_tpu_torch.tools import device_ms

    with torch.inference_mode():
        out = trainer.eval_step(inputs)
        pc = inputs["point_clouds"]
        parts = {"empty-box removal": lambda: trainer._nonempty(out, pc),
                 "device NMS incl. removal": lambda: trainer._nms_keep(
                     out, pc)}
        res = {}
        for name, fn in parts.items():
            res[name] = {"ms": time_ms(fn, reps=5),
                         "device_ms": device_ms(fn, reps=3)}
    B = pc.shape[0]
    log(f"eval step keyed B={B}, the part above the forward: "
        + "; ".join(f"{k} {v['ms']:.2f} ms by CUDA events, "
                    f"{v['device_ms']:.2f} device ms"
                    for k, v in res.items())
        + f"; card {power}")
    return res


def run_ap(trainer, cfg, scenes: int = 4, batch: int = 2):
    """`evaluate` with `APCalculator` over a few synthetic scenes on the
    card, end to end: mAP and AR at 0.25 and 0.5 (near 0 with random
    weights), finite, and the IoU path that scored."""
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.data.synthetic import (SyntheticDetectionDataset,
                                                collate)
    from vdetr_tpu_torch.eval.ap_calculator import APCalculator
    from vdetr_tpu_torch.train.engine import evaluate

    ds = ScannetDatasetConfig()
    data = SyntheticDetectionDataset(ds, cfg.num_points, seed=SEED)
    batches = [collate([data[i + j] for j in range(batch)])
               for i in range(0, scenes, batch)]
    # one process, as the quality proof runs it: spawned workers cost
    # more than the per-class loop at this size
    calc = APCalculator(ds, ap_iou_thresh=[0.25, 0.5],
                        class2type_map=ds.class2type,
                        ap_config_dict=trainer.ap_config,
                        axis_align_test=cfg.axis_align_test, processes=1)
    t0 = time.perf_counter()
    evaluate(trainer, batches, calc, logger=None)
    t_steps = time.perf_counter() - t0
    metrics = calc.metrics_to_dict(calc.compute_metrics())
    t_all = time.perf_counter() - t0
    ok = (calc.scan_cnt == scenes
          and all(math.isfinite(float(v)) for v in metrics.values()))
    log(f"AP end to end, {scenes} synthetic scenes at B={batch} (keyed "
        f"route, random weights): "
        + ", ".join(f"{k} {float(v):.2f}" for k, v in metrics.items())
        + f"; IoU path {calc.iou_path}; eval steps and the AP's host "
        f"parse {t_steps:.2f} s, with the AP's metrics {t_all:.2f} s -> "
        f"{'ok' if ok else 'FAIL'}")
    return ok, {"metrics": {k: float(v) for k, v in metrics.items()},
                "iou_path": calc.iou_path, "wall_s": t_all}


def check_small_eval_against_cpu(device, route):
    """A small model's eval step with `test_only` on `route`: kernels (N
    among them) on the card against the plain versions on the CPU, same
    weights and inputs: the keep mask equal, the outputs within the small
    forward's tolerance."""
    import copy

    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.models.vdetr import build_model
    from vdetr_tpu_torch.train.engine import Trainer

    cfg = tiny_config().replace(test_only=True, matcher_impl="jv")
    ds = ScannetDatasetConfig()
    gen = torch.Generator().manual_seed(SEED + 2)
    model = build_model(cfg, ds, generator=gen, device="cpu",
                        conv_route=route)
    with torch.no_grad():  # non-trivial heads
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    rng = np.random.RandomState(SEED)
    pts = (rng.rand(2, cfg.num_points, 3) * [1.2, 1.2, 0.6]).astype(
        np.float32)
    batch = {"point_clouds": pts, "point_cloud_dims_min": pts.min(1),
             "point_cloud_dims_max": pts.max(1)}
    card_trainer = Trainer(cfg, copy.deepcopy(model), ds, 1, device=device)
    ref = Trainer(cfg, model, ds, 1, device="cpu").eval_step(batch)
    got = card_trainer.eval_step(batch)
    torch.cuda.synchronize()
    same = bool(torch.equal(got["nms_keep"].cpu(), ref["nms_keep"]))
    err = max(float((got[k].cpu().float() - v.float()).abs().max())
              for k, v in ref.items() if k != "nms_keep")
    tol = 1e-3
    ok = same and err <= tol
    log(f"eval step {route} small config (test_only) on card vs CPU plain "
        f"path: nms_keep equal={same} ({int(ref['nms_keep'].sum())} of "
        f"{ref['nms_keep'].numel()} kept), max_abs_err over outputs="
        f"{err:.3e} tol={tol:.0e} (f32 rounding through ~40 layers) -> "
        f"{'ok' if ok else 'FAIL'}")
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


DECODER_DONE = "phase mark: gradient at the decoder's input"


def step_breakdown(trainer, batch, gen, profiled: bool = False):
    """One train step written out phase by phase, each phase ended by a
    synchronization: forward, criterion (its matcher copies the costs to
    the host), backward split at the decoder's input, clip and AdamW.
    Host-clock ms per phase, and the two stream spans of the backward:
    CUDA events recorded when it starts, when the gradient reaches the
    projection's output and when it ends. A stream span holds the time the
    host leaves the stream idle, so it is not device time. `profiled`: the
    step runs under torch.profiler with a synchronization at the
    decoder's input too, and the result also holds the device ms of each
    phase (the union of its device intervals, and the sum of its kernels'
    times), `device: <phase>`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

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

    def decoder_done(g):
        if profiled:  # the decoder's backward ends before the mark
            torch.cuda.synchronize()
            with record_function(DECODER_DONE):
                pass
        mark("decoder_done")

    def on_projection(module, args, out):  # returns None: output kept
        out.register_hook(decoder_done)

    hook = model.encoder_to_decoder_projection.register_forward_hook(
        on_projection)
    host = {}

    def phase(name, fn):
        with record_function("phase: " + name):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            host[name] = (time.perf_counter() - t0) * 1e3
        return res

    def backward(loss):
        mark("backward_start")
        loss.backward()
        mark("backward_end")

    def optimizer():
        clip_by_global_norm(model.parameters(), trainer.cfg.clip_gradient)
        opt.step()

    model.train()
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    try:
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext()) as prof:
            out = phase("forward", lambda: model(inputs, generator=gen))
            loss, _ = phase("criterion incl. matcher", lambda: crit(out, b))
            phase("backward", lambda: backward(loss))
            phase("clip and AdamW", optimizer)
    finally:
        hook.remove()
    t = dict(host)
    t["backward: decoder and heads (stream span)"] = ev["backward_start"] \
        .elapsed_time(ev["decoder_done"])
    t["backward: projection, FPN and backbone (stream span)"] = \
        ev["decoder_done"].elapsed_time(ev["backward_end"])
    if prof is None:
        return t
    # device intervals by the phase their start falls in: each phase ends
    # in a synchronization, so none of its device work outlives it
    windows, split = [], None
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name.startswith("phase: "):
            windows.append((e.time_range.start, e.time_range.end,
                            e.name[len("phase: "):]))
        elif e.name == DECODER_DONE:
            split = e.time_range.start
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    spans = {}
    for e in dev:
        a, z = e.time_range.start, e.time_range.end
        name = next((w for lo, hi, w in windows if lo <= a < hi), None)
        if name is None:
            continue
        if name == "backward" and split is not None:
            name = ("backward: decoder and heads" if a < split else
                    "backward: projection, FPN and backbone")
        spans.setdefault(name, []).append((a, z))
    for name, iv in spans.items():
        busy, end = 0.0, -math.inf
        for a, z in sorted(iv):  # union of the phase's device intervals
            if z > end:
                busy += z - max(a, end)
                end = z
        t[f"device: {name}"] = busy / 1e3
        t[f"device kernel sum: {name}"] = sum(z - a for a, z in iv) / 1e3
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


# kernel function names (as the profiler reports them) -> the port's
# kernels and the part of it; the first match wins; "conv" is the route's
# 3^3 conv (A or H, which share conv_sum_splits_kernel), "dW" its weight
# gradient (D or I, which share dw_kernel and dw_sum_splits_kernel); F
# runs the pair kernel, the sum of its key shares' dQ and the dTables
# table kernel
PROFILE_KERNELS = (("neighbour_map_kernel", "keyed_conv_dw", "private map"),
                   ("dw_rulebook_kernel", "dW", "rulebook"),
                   ("conv_sum_splits_kernel", "conv", "split sums"),
                   ("dw_sum_splits_kernel", "dW", "split sums"),
                   ("dw_kernel", "dW", "dW GEMM"),
                   ("keyed_conv_kernel", "keyed_conv", "conv"),
                   ("mapped_conv_kernel", "mapped_conv", "conv"),
                   ("map_kernel", "kernel_map", "map"),
                   ("fps_kernel", "fps", "fps"),
                   ("rpe_attention_kernel", "rpe_cross_attention", "forward"),
                   ("rpe_pair_bwd_kernel", "rpe_cross_attention_bwd",
                    "pair kernel"),
                   ("rpe_dq_sum_kernel", "rpe_cross_attention_bwd",
                    "dq sum"),
                   ("rpe_table_bwd_kernel", "rpe_cross_attention_bwd",
                    "table kernel"),
                   ("rpe_table_sum_kernel", "rpe_cross_attention_bwd",
                    "table sum"))


def profile_step(trainer, batch, gen):
    """One train step under torch.profiler with CUDA activity: device ms
    and launches per kernel name summed over the step, the same per port
    kernel, and the device's busy time (the union of device activity;
    user annotations, which span other events, left out) over the step's
    host-clock time with the profiler on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:  # union of the device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    conv = f"{trainer.model.conv_route}_conv"
    alias = {"conv": conv, "dW": conv + "_dw"}
    by_name, by_kernel, by_part = {}, {}, {}
    for e in dev:
        us = e.time_range.end - e.time_range.start
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + us / 1e3, n + 1)
        port = next(((alias.get(k, k), part)
                     for pat, k, part in PROFILE_KERNELS if pat in e.name),
                    None)
        if port is not None:
            ms, n = by_kernel.get(port[0], (0.0, 0))
            by_kernel[port[0]] = (ms + us / 1e3, n + 1)
            ms, n = by_part.get(port, (0.0, 0))
            by_part[port] = (ms + us / 1e3, n + 1)
    device_ms = sum(ms for ms, _ in by_name.values())
    port_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return dict(wall_ms=wall, device_events=len(dev),
                device_busy_ms=busy_us / 1e3,
                busy_share=busy_us / 1e3 / wall if wall > 0 else 0.0,
                device_ms=device_ms, port_kernels_ms=port_ms,
                by_kernel={k: {"ms": ms, "launches": n}
                           for k, (ms, n) in by_kernel.items()},
                by_part={f"{k} {part}": {"ms": ms, "launches": n}
                         for (k, part), (ms, n) in by_part.items()},
                top=[{"name": name[:120], "ms": ms, "launches": n}
                     for name, (ms, n) in top])


def run_train(cfg, device, power, warm: int = 3, steps: int = 5):
    """The published model's train step at batch 1 on both routes, each
    with its own model (the same initial weights), optimizer and dropout
    generator (the same seed): `warm` steps, then `steps` timed steps, the
    routes in turn on the same batch (the order alternating), so that
    their medians share the call's conditions. Each step's launches are
    counted."""
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.tools.determinism import grad_spread, step_twice
    from vdetr_tpu_torch.train.engine import Trainer

    ds = ScannetDatasetConfig()
    trainers = {route: Trainer(cfg, published_model(cfg, device, route), ds,
                               steps_per_epoch=1000, device=device)
                for route in ROUTES}
    expected = {route: expected_launches(tr.model, cfg, train=True)
                for route, tr in trainers.items()}
    gens = {route: torch.Generator(device=device).manual_seed(SEED)
            for route in ROUTES}
    counters = launch_counters()
    batches = [train_batch(cfg, 1, first=i) for i in range(warm + steps)]
    ok, launches = True, {}
    times = {route: [] for route in ROUTES}
    all_times = {route: [] for route in ROUTES}
    peak = {route: 0.0 for route in ROUTES}
    for i, batch in enumerate(batches):
        for route in (ROUTES if i % 2 == 0 else ROUTES[::-1]):
            trainer = trainers[route]
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats(device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, parts = trainer.train_step(batch, gens[route])
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            counts = {k: fn.launches for k, fn in counters.items()}
            peak[route] = max(
                peak[route], torch.cuda.max_memory_allocated(device) / 2 ** 30)
            nonfinite = grads_finite(trainer.model)
            step_ok = (math.isfinite(loss) and not nonfinite
                       and counts == expected[route])
            ok &= step_ok
            all_times[route].append(dt)
            if i == 0:
                launches[route] = counts
            if i >= warm:
                times[route].append(dt)
            log(f"train {route} step {i}{' (warm)' if i < warm else ''}: "
                f"loss {loss:.4f}, {dt:.1f} ms, grads "
                f"{'finite' if not nonfinite else nonfinite[:3]}, launches "
                + fmt_counts(counts, expected[route])
                + f" -> {'ok' if step_ok else 'FAIL'}")
    stats = {}
    for route, trainer in trainers.items():
        med = statistics.median(times[route])
        log(f"train {route} B=1 N={cfg.num_points} matcher="
            f"{cfg.matcher_impl}: median {med:.1f} ms/step over "
            f"{len(times[route])} steps after {warm} warm, in turn with the "
            f"other route [{', '.join(f'{t:.1f}' for t in times[route])}]; "
            f"all steps [{', '.join(f'{t:.1f}' for t in all_times[route])}];"
            f" peak memory {peak[route]:.2f} GiB (both routes' weights and "
            f"optimizer states resident); card {power}")
        brk = step_breakdown(trainer, batches[1], gens[route])
        brk["matcher: cost copy and JV on the host"] = matcher_host_ms(
            trainer, batches[1], gens[route])
        log(f"train {route} step breakdown (ms; host clock per phase, each "
            "ended by a sync; the backward's stream spans between CUDA "
            "events, which include the host's gaps): " + "; ".join(
                f"{k} {v:.1f}" for k, v in brk.items()))
        dev_brk = step_breakdown(trainer, batches[1], gens[route],
                                 profiled=True)
        log(f"train {route} step breakdown under torch.profiler (ms; "
            "'device': the union of the phase's device intervals, 'device "
            "kernel sum': their sum; host clock with the profiler on): "
            + "; ".join(f"{k} {v:.1f}" for k, v in dev_brk.items()))
        spread = grad_spread(trainer, batches[1])
        repeat_ok = not spread["differing"] and all(
            v["max_abs_diff"] == 0 for v in spread["groups"].values())
        log(f"train {route} run-to-run gradient spread (two backwards from "
            "the same state, batch and seed; max |g1 - g2| / max |g1| per "
            "parameter group, tolerance 0): " + "; ".join(
                f"{k} {v['rel']:.2e}" for k, v in spread["groups"].items())
            + f"; {len(spread['differing'])} parameters differ "
            f"{[n for n, _ in spread['differing'][:5]]} -> "
            f"{'ok' if repeat_ok else 'FAIL'}")
        differ, count = step_twice(trainer, batches[1])
        log(f"train {route} two whole steps (clip and AdamW included) from "
            f"the same state, batch and seed: {len(differ)} of {count} "
            f"parameters differ {differ[:5]} -> "
            f"{'ok' if not differ else 'FAIL'}")
        ok &= repeat_ok and not differ
        stats[route] = dict(ms_per_step=med, steps=times[route],
                            all_steps=all_times[route], peak_gib=peak[route],
                            breakdown=brk, breakdown_profiled=dev_brk,
                            grad_spread=spread["groups"],
                            grad_spread_differing=spread["differing"],
                            step_twice_differing=differ)
        prof = profile_step(trainer, batches[2], gens[route])
        prof["busy_share_of_median_step"] = prof["device_busy_ms"] / med
        stats[route]["profile"] = prof
        log(f"train {route} step under torch.profiler: {prof['wall_ms']:.1f}"
            f" ms host clock, {prof['device_events']} device events, "
            f"device busy {prof['device_busy_ms']:.1f} ms = "
            f"{100 * prof['busy_share']:.1f}% of the profiled step, "
            f"{100 * prof['busy_share_of_median_step']:.1f}% of the "
            f"median step ({med:.1f} ms, profiler off); device ms in all "
            f"{prof['device_ms']:.1f}, in the port's kernels "
            f"{prof['port_kernels_ms']:.1f}; card {power}")
        log("  per port kernel (ms, launches): " + "; ".join(
            f"{k} {v['ms']:.2f} ({v['launches']})"
            for k, v in sorted(prof["by_kernel"].items())))
        log("  per kernel part (ms, launches): " + "; ".join(
            f"{k} {v['ms']:.2f} ({v['launches']})"
            for k, v in sorted(prof["by_part"].items())))
        log("  top kernels by device ms: " + "; ".join(
            f"{t['name'][:60]} {t['ms']:.2f} ({t['launches']})"
            for t in prof["top"]))
    # the same batch on both routes: the paired difference cancels the
    # scene-to-scene variation of the step
    diff = [m - k for k, m in zip(times["keyed"], times["mapped"])]
    stats["mapped_minus_keyed_ms"] = diff
    log(f"train mapped minus keyed, paired by step: median "
        f"{statistics.median(diff):.1f} ms ["
        + ", ".join(f"{d:.1f}" for d in diff) + "]")
    return ok, launches, stats


def check_small_train_against_cpu(device, route):
    """One train step of a small model (dropout 0) on `route` on the card
    against the same step on the CPU through the plain versions: same
    weights, same batch."""
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
                      device="cpu", conv_route=route)
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
    log(f"train {route} step small config on card vs CPU plain path: loss "
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
    smi = card()
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
    res = {"kernel_map": check_kernel_map(cfg, grids)}
    cases = conv_cases(cfg, grids, gen)
    res["keyed_conv"] = check_keyed_conv(cases)
    res["keyed_conv_dw"] = check_keyed_conv_dw(cases)
    res["mapped_conv"] = check_mapped_conv(cases)
    res["mapped_conv_dw"] = check_mapped_conv_dw(cases)
    del cases
    res["fps"] = check_fps(cfg, grids)
    res["rpe_cross_attention"], case = check_rpe(cfg, device, gen)
    res["rpe_cross_attention_bwd"] = check_rpe_bwd(cfg, case)
    res["rpe_table_sum"] = check_rpe_table_sum(cfg, device, gen)
    del case, grids

    # 3b. the probes of kernel C
    res["rpe_ablate"] = check_rpe_ablate(device)
    res["dot_micro"] = check_dot_micro(device)

    # 4. the published forward on both routes, then a small one on each
    # against the CPU
    models = {route: published_model(cfg, device, route) for route in ROUTES}
    ok_f, fwd_launches, per_scene = run_forward(models, cfg, device, smi)
    ok_fpn, fpn_err = compare_fpn(models, cfg, device)

    # 4b. the published eval step (test_only) on both routes, kernel N
    # against its plain loop (random boxes and the steps' own NMS inputs),
    # the AP end to end
    ecfg = eval_config(cfg)
    ok_e, eval_launches, eval_per, captured, trainers = run_eval(
        models, ecfg, device, smi)
    res["nms"] = check_nms(device, captured, ecfg.nms_iou)
    ok_ap, ap = run_ap(trainers["keyed"], ecfg)
    del models, trainers, captured
    ok_s = all(check_small_forward_against_cpu(
        device, torch.Generator().manual_seed(SEED + 1), route)
        for route in ROUTES)
    # a small eval step on each route against the CPU
    ok_se = all(check_small_eval_against_cpu(device, route)
                for route in ROUTES)

    # 5. the published train step on both routes, then a small one on each
    # against the CPU
    ok_t, train_launches, train = run_train(cfg.replace(matcher_impl="jv"),
                                            device, smi)
    ok_ts = all(check_small_train_against_cpu(device, route)
                for route in ROUTES)
    log("keyed vs mapped route (ms): forward/scene B=1 "
        f"{per_scene['keyed'][1]:.2f} vs {per_scene['mapped'][1]:.2f}, B=4 "
        f"{per_scene['keyed'][4]:.2f} vs {per_scene['mapped'][4]:.2f}; "
        f"train step {train['keyed']['ms_per_step']:.1f} vs "
        f"{train['mapped']['ms_per_step']:.1f}; card {smi}")

    record = {"kernels": []}
    for kname, r in res.items():
        src, repl = REPO_SOURCES[kname]
        route = "mapped" if kname in ("kernel_map", "mapped_conv",
                                      "mapped_conv_dw") else "keyed"
        launches = (eval_launches[route][kname] if kname == "nms"
                    else train_launches[route][kname])
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": repl, "launches": launches,
                 "max_abs_err": r["err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"],
                 "library_ms": r.get("library_ms"),
                 "library": r.get("library")
                 or "none: " + LIBRARY_NONE[kname],
                 "forward_launches": fwd_launches[route][kname],
                 "launches_by_route": {
                     rt: {"forward": fwd_launches[rt][kname],
                          "eval_step": eval_launches[rt][kname],
                          "train_step": train_launches[rt][kname]}
                     for rt in ROUTES}}
        for extra in ("cases", "train_ms", "gather_matmul_ms",
                      "library_tf32_ms", "bound_f32_ms", "bound_note",
                      "ms_dropout0", "pair_ms", "pair_ms_dropout0",
                      "dq_sum_ms", "pair_bound_ms", "pair_bound_by",
                      "pair_bound_f32_ms", "pair_sass", "table_ms",
                      "table_bound_ms", "table_bound_by", "table_sass",
                      "table_sum_ms", "forward_maps", "ms_note", "slices",
                      "exchange_floor_ms", "device_ms", "mask_ms",
                      "scan_ms", "mask_bytes"):
            if extra in r:
                entry[extra] = r[extra]
        if kname == "nms":
            entry["launches_note"] = ("per eval step (the main path's end); "
                                      "the forward and the train step run "
                                      "no NMS")
        if kname in PROBES:
            entry["probe"] = ("a probe of kernel C, off the main path: 0 "
                              "launches there; ms, plain_ms and bound_ms sum "
                              "its cases")
        record["kernels"].append(entry)
    record["forward_ms_per_scene"] = {
        route: {f"B={b}": t for b, t in per_scene[route].items()}
        for route in ROUTES}
    record["eval_step"] = {
        route: {f"B={b}": v for b, v in eval_per[route].items()}
        for route in ROUTES}
    record["ap_end_to_end"] = ap
    record["fpn_mapped_vs_keyed_max_abs_err"] = fpn_err
    record["train"] = train
    record["card"] = smi
    log(json.dumps(record))
    if not (all(r["ok"] for r in res.values()) and ok_f and ok_fpn and ok_s
            and ok_e and ok_ap and ok_se and ok_t and ok_ts):
        log("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
