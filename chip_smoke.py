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
     pair kernel's two products as torch.matmul beside it), the
     slices' sum (bit for bit against its plain version), and the
     matcher's auction (M: col4row and rounds bit for bit, on the
     published criterion's cost groups at batch 1 and 4, on exact ties,
     on duplicated GT rows and on a problem cut at max_iters); prints the
     error, its tolerance, both times and the kernel's bound (for A, D, H
     and I, which multiply on the tensor cores in split TF32, against the
     TF32 rate, with the f32 CUDA-core bound beside it); I bit for bit
     against D and against a second call of itself; the bf16 forms of A,
     D, H and I (compute_dtype="bfloat16": bf16 features and weights, D
     and I against f32 dout's two bf16 halves; all four on wgmma behind
     an mbarrier ring, csrc/sparse_conv_sm90.cuh) against their plain
     versions at the same shapes, each beside the f32 form's ms of the
     call and the bf16 bound, H bit for bit against A's bf16 form and I
     against D's, each of the four bit for bit from call to call;
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
  5. train, on both routes under the auction matcher (the default) and
     on the keyed route under JV: the published model's train step
     (Trainer, batch 1, dropout on), the three variants' steps in turn on
     the same batches: three warm steps, then timed steps with finite
     loss and gradients and the expected launches per step (A, D or G,
     H, I; B, C, F and its slices' sum; M twice under the auction),
     median ms per step, peak memory, and for the auction's two variants
     a breakdown by phase (host ms,
     the matcher alone, and the backward's stream spans), the criterion
     under torch.cuda.set_sync_debug_mode("error") (the auction's makes
     no synchronizing call), the same breakdown under torch.profiler
     (device ms per phase); the
     run-to-run spread of the gradients (two backwards from the same
     state, batch and seed), which must be exactly 0 for every
     parameter, and two whole steps from one state, which must leave the
     same parameters bit for bit (`vdetr_tpu_torch/tools/determinism.py`);
     one step per route under torch.profiler (device ms per kernel and
     per device function summed over its launches, the device's busy
     share); and a small
     model's step on each route on the card against the same step on the
     CPU (dropout 0): loss, every gradient and the updated parameters;
  6. the CLI, `vdetr_tpu_torch.main.main`, at the VDETRConfig defaults on
     fabricated ScanNet-format scans (4 train and 2 val scans of
     150k-250k vertices, written to a temporary directory): one epoch
     with a checkpoint directory (its launches per kernel counted: every
     kernel of the keyed path, M included), `--test_only --auto_test` on
     checkpoint_best reproducing the final eval's mAP exactly (at
     --empty_pt_thre 0), and a second epoch resumed from the checkpoint;
     the wall ms of each train step and seconds of each eval pass;
  7. SUN RGB-D (oriented boxes, 12 angle bins) at the published width,
     `VDETRConfig(dataset_name="sunrgbd", angle_type="object_coords")`:
     kernel R (the rotated GIoU's intersection areas) against its plain
     version on every job of the published criterion at batch 1 and 4
     and on edge cases (identical, nested, edge-sharing, collinear,
     corner-touching, zero-size and gated-off pairs): the forward bit for
     bit, the backward against autograd of the plain version and bit for
     bit from a second launch, with its times, the plain version's, the
     bound and the gated share; the eval step on both routes at batch 1
     and 4 (ms/scene, launches), the AP end to end with the device NMS
     and with the host's rotated NMS; a small forward, eval step and
     train step per route on the card against the CPU; the train step on
     both routes under the auction (launches, R included, bit-equal
     parameters after two whole steps, the profiled step, the keyed
     route's breakdown, median,
     peak memory); one step each under iou_type "diou" and "iou" (ms,
     peak memory); the CLI on fabricated SUN RGB-D scans in VoteNet's
     layout (train, --test_only --auto_test, resume);
  9. data parallel (run after 7, before 8's lines), each group of ranks
     spawned under a time limit (`vdetr_tpu_torch/tools/dp_step.py`):
     (a) world size 1 on NCCL: the published model (keyed, batch 1, the
     auction, dropout on) under DDP and sync-BN against the plain Trainer
     in one process: two whole steps from one state leave the parameters
     and running statistics bit for bit equal, with equal losses and
     launches; the two steps' medians in turns; the collectives of one
     profiled step of each (none without a group) with their device ms;
     (b) two ranks on the one card over gloo (NCCL refuses two ranks on
     one device), the small config: the loss, every gradient and the
     updated parameters against the same two ranks on the CPU, at the
     small train step's tolerances, both ranks bit-equal; (c) two ranks
     on the card over gloo at the published width (dropout on, the
     auction), two steps: finite losses, both ranks' parameters and
     statistics bit-equal, each rank's launches per kernel as the
     single-card step's (phase 5), ms per step, peak memory per rank and
     a profiled step's collectives;
  10. the JAX model's other configurations at published widths: (a) the
     bf16 backbone (`VDETRConfig(compute_dtype="bfloat16")`): the eval
     step on both routes at batch 1 and 4 and the train step on both
     routes (as phases 4b and 5: launches per form, two steps bit for
     bit, the profiled step: the bf16 forms' device ms a step go into
     the kernels line), its A/D (keyed) and H/I (mapped) launches
     in all equal to the f32 step's, peak memory and median beside the
     f32 step's; (b) `VDETRConfig(depth=50)` (Bottleneck) and (c) every
     decoder and head flag (`pos_for_key`, `share_selfattn`,
     `querypos_mlp=False`, `mlp_norm="ln"`, `mlp_act="gelu"`,
     `random_fps`) on the keyed route: one eval step and two train steps,
     launches, ms, peak memory; (d) small configs of each on the card
     against the CPU: the bf16 forward (well-posed, its queries matched),
     the flags' and depth 50's forward and eval step, the flags' train
     step, and the bf16 and depth-50 train steps' loss and every sparse
     conv call in them against the CPU on the same inputs (those two
     steps sit on kinks of the loss where whole gradients are ill-posed);
  11. key sharding, the large-scene stress config (a "seq" mesh axis):
     (a) kernel C on each of two shards of 4096 keys (the dropout hash
     reading global key indices) merged by their log-sum-exps, and kernel
     F on each shard from the global out and lse, against the plain dense
     version over 8192 keys at 1024 queries, forward and backward, at
     dropout 0 and 0.1 under one seed; (b) a small seq step at mesh
     (1, 2), two ranks on the card over gloo, against the same ranks on
     the CPU; (c) the pointnet2 SA and FP modules on the card against the
     CPU; then mesh (1, 2) at `VDETRConfig()` widths with 200000 points a
     scene (100k a rank), two ranks sharing the card over gloo: one eval
     step at B = 1 and two train steps, run twice from the same weights
     (bit-equal), both ranks' parameters equal, every kernel of the path
     launched, ms a step and peak memory a rank;
  8. a JSON line of per-kernel results, then the last line
     {"ok": true, "device": {...}} -- printed only when every phase
     passed.

Exits non-zero without printing a result when CUDA is unavailable, or
when any phase fails. Imports no jax.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vdetr_tpu_torch.tools import (PEAK_BYTES, PEAK_F32_FLOPS,
                                   PEAK_TF32_FLOPS, bound_bf16_ms, bound_ms,
                                   bound_split_tf32_ms, card,
                                   launch_counters, time_ms)

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
    # no pallas_call: the JAX train step's matcher is jax.lax.while_loops
    "auction": ("vdetr_tpu_torch/csrc/auction.cu",
                "vdetr_tpu/ops/hungarian.py:123,223 (jax.lax.while_loop in "
                "XLA, not a pallas_call)"),
    # no pallas_call: the JAX criterion's rotated GIoU is a fori_loop in a
    # lax.scan, vmapped over the pairs
    "rotated_iou": ("vdetr_tpu_torch/csrc/rotated_iou.cu",
                    "vdetr_tpu/geometry/iou.py:71 _clip_quad_quad, vmapped "
                    "at :141 rotated_intersection_areas (jax.lax.fori_loop "
                    "in XLA, not a pallas_call)"),
}
# the bf16 forms (compute_dtype="bfloat16"): second entries of their f32
# forms' sources, the same TPU kernels replaced
for _name in ("keyed_conv", "keyed_conv_dw", "mapped_conv", "mapped_conv_dw"):
    REPO_SOURCES[_name + "_bf16"] = REPO_SOURCES[_name]
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
    "auction": "no torch op solves an assignment problem",
    "rotated_iou": "no torch op clips one quad by another (the "
                   "intersection area of two rotated rectangles)",
}
for _name in ("keyed_conv", "keyed_conv_dw", "mapped_conv", "mapped_conv_dw"):
    LIBRARY_NONE[_name + "_bf16"] = LIBRARY_NONE[_name]


def log(*args):
    print(*args, flush=True)


def _dominant(cases) -> str:
    """What bounds the case with the largest bound."""
    return max(cases, key=lambda c: c["bound_ms"])["bound_by"]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dataset_of(cfg):
    """The dataset config that `cfg.dataset_name` names: ScanNet's for
    "scannet" and "synthetic", SUN RGB-D's (10 classes, 12 angle bins)
    for "sunrgbd"."""
    from vdetr_tpu_torch.data.dataset_config import get_dataset_config

    return get_dataset_config(cfg.dataset_name)


def synthetic_batch(num_points: int, batch: int, device, first: int = 0,
                    ds=None):
    """The model inputs of `batch` synthetic scenes of dataset config `ds`
    (ScanNet's when None; an angle-binned one's boxes are yawed)."""
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.data.synthetic import (SyntheticDetectionDataset,
                                                collate)

    ds = SyntheticDetectionDataset(ds or ScannetDatasetConfig(), num_points,
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
                      kargs_of, computed, bound_fn=bound_split_tf32_ms,
                      bound_note=None):
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
        b_ms, b_by = bound_fn(io, flops)
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
            f"{b_ms:.4f} ms ({b_by}, "
            + ("split TF32" if bound_fn is bound_split_tf32_ms else "bf16")
            + " on the tensor cores; f32 "
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
                bound_note=bound_note or (
                    "bound_ms: split TF32 on the tensor cores (3 x flops / "
                    "495 TFLOP/s against bytes / 3.35 TB/s); bound_f32_ms: "
                    "flops / 67 TFLOP/s on the CUDA cores"))


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
    """The (row, offset) products kernels D and I compute on a case, in the
    form the case's features take (bf16: the stem's channels padded to 8):
    in the dense form every row for all 27 offsets, else each offset's
    hits from the rulebook, a split's last stage padded (32 rows in the
    f32 form, 64 in the bf16 form). Only the hit share reads it: the
    bound counts the function's work, the (row, offset) hits."""
    from vdetr_tpu_torch.ops.sparse_conv_kernel import (
        dw_dense, dw_row_splits, dw_rulebook)

    nbr, (feats, *_, w) = case[4], case[1]
    B, _, V = nbr.shape
    bf16 = feats.dtype == torch.bfloat16
    C, Co = w.shape[1] + (-w.shape[1] % 8 if bf16 else 0), w.shape[2]
    stage = 64 if bf16 else 32
    splits, per = dw_row_splits(B * V, C, Co, bf16=bf16)
    if dw_dense(C, bf16):
        rows = torch.clamp(B * V - per * torch.arange(splits), 0, per)
    else:
        rows = dw_rulebook(nbr, feats.shape[1], splits, per)[2].long()
    return (int(((rows + stage - 1) // stage).sum()) * stage
            * (27 if dw_dense(C, bf16) else 1))


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
    slices, once per decoder layer, FPS once. A train step under the
    auction matcher: M once per shape group of the criterion's jobs, the
    repeated jobs' and the bilabel aux0's (none under JV). A train step
    of an angle-binned dataset (SUN RGB-D) under the GIoU: R once forward
    and once backward per job (the decoder's `dec_nlayers` outputs). The
    probes (rpe_ablate, dot_micro) never."""
    from vdetr_tpu_torch.models.backbone import SparseConv, SparseConvDown

    k3 = [m for m in model.modules()
          if isinstance(m, (SparseConv, SparseConvDown))
          and m.kernel_size == 3]
    # each submanifold conv's dFeats: the conv again, on flipped weights,
    # in the f32 form (the f32 cotangent, also under bf16)
    dfeats = sum(isinstance(m, SparseConv) for m in k3) if train else 0
    # under compute_dtype="bfloat16" the forward and the weight gradient
    # take the bf16 forms
    form = "_bf16" if cfg.compute_dtype == "bfloat16" else ""
    layers = cfg.dec_nlayers - 1
    out = {k: 0 for k in launch_counters()}
    out.update(fps=1, rpe_cross_attention=layers)
    conv = "keyed_conv" if model.conv_route == "keyed" else "mapped_conv"
    out[conv + form] += len(k3)
    out[conv] += dfeats
    if model.conv_route == "mapped":
        out["kernel_map"] = sum(isinstance(m, SparseConvDown) for m in k3)
    if train:
        out[conv + "_dw" + form] = len(k3)
        out["rpe_cross_attention_bwd"] = layers
        out["rpe_table_sum"] = layers
        if cfg.matcher_impl == "auction":
            out["auction"] = 1 + int(cfg.is_bilable)
        if (dataset_of(cfg).num_angle_bin > 1
                and cfg.iou_type not in ("diou", "iou")):
            out["rotated_iou"] = 2 * cfg.dec_nlayers
    return out


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
    """The published model of `cfg`'s dataset on `route`, its weights
    from the seed (the same on both routes)."""
    from vdetr_tpu_torch.models.vdetr import build_model

    return build_model(cfg, dataset_of(cfg),
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


def check_small_forward_against_cpu(device, gen, route, base=None):
    """The whole forward at a small size on `route` (`base`: a small config
    of another dataset, `tiny_config()` when None): kernels on the card
    against the plain versions on the CPU, same weights and inputs."""
    from vdetr_tpu_torch.models.vdetr import build_model

    cfg = base or tiny_config()
    model = build_model(cfg, dataset_of(cfg), generator=gen,
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
    log(f"forward {route} small {cfg.dataset_name} config on card vs CPU "
        "plain path: seeds "
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
    on)."""
    return cfg.replace(test_only=True)


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
    difference (the sigmoid, empty-box removal and NMS). The scenes are
    synthetic ones of `cfg`'s dataset."""
    from vdetr_tpu_torch.train import engine

    ds = dataset_of(cfg)
    trainers = {route: engine.Trainer(cfg, m, ds, 1, device=device)
                for route, m in models.items()}
    counters = launch_counters()
    real_nms = engine.nms_3d_samecls_mask
    ok, launches, captured = True, {}, []
    per = {route: {} for route in models}
    for B in (1, 4):
        inputs = synthetic_batch(cfg.num_points, B, device, ds=ds)
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
            log(f"eval step {cfg.dataset_name} {route} B={B} "
                f"N={cfg.num_points}: launches "
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
            log(f"eval step {cfg.dataset_name} {route} B={B}: {step:.2f} "
                "ms/scene, forward "
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
    """`evaluate` with `APCalculator` over a few synthetic scenes of
    `cfg`'s dataset on the card, end to end, under the trainer's AP
    config: mAP and AR at 0.25 and 0.5 (near 0 with random weights),
    finite, and the IoU path that scored."""
    from vdetr_tpu_torch.data.synthetic import (SyntheticDetectionDataset,
                                                collate)
    from vdetr_tpu_torch.eval.ap_calculator import (APCalculator,
                                                    device_nms_supported)
    from vdetr_tpu_torch.train.engine import evaluate

    ds = dataset_of(cfg)
    data = SyntheticDetectionDataset(ds, cfg.num_points, seed=SEED)
    batches = [collate([data[i + j] for j in range(batch)])
               for i in range(0, scenes, batch)]
    calc = APCalculator(ds, ap_iou_thresh=[0.25, 0.5],
                        class2type_map=ds.class2type,
                        ap_config_dict=trainer.ap_config,
                        axis_align_test=cfg.axis_align_test)
    t0 = time.perf_counter()
    evaluate(trainer, batches, calc, logger=None)
    t_steps = time.perf_counter() - t0
    metrics = calc.metrics_to_dict(calc.compute_metrics())
    t_all = time.perf_counter() - t0
    ok = (calc.scan_cnt == scenes
          and all(math.isfinite(float(v)) for v in metrics.values()))
    nms = ("the device NMS" if device_nms_supported(trainer.ap_config)
           else "the host's " + ("rotated NMS" if trainer.ap_config[
               "rotated_nms"] else "NMS"))
    log(f"AP end to end, {scenes} synthetic {cfg.dataset_name} scenes at "
        f"B={batch} (keyed route, random weights, {nms}): "
        + ", ".join(f"{k} {float(v):.2f}" for k, v in metrics.items())
        + f"; IoU path {calc.iou_path}; eval steps and the AP's host "
        f"parse {t_steps:.2f} s, with the AP's metrics {t_all:.2f} s -> "
        f"{'ok' if ok else 'FAIL'}")
    return ok, {"metrics": {k: float(v) for k, v in metrics.items()},
                "iou_path": calc.iou_path, "wall_s": t_all, "nms": nms}


def check_small_eval_against_cpu(device, route, base=None):
    """A small model's eval step with `test_only` on `route` (`base`: a
    small config of another dataset): kernels (N among them) on the card
    against the plain versions on the CPU, same weights and inputs: the
    keep mask equal, the outputs within the small forward's tolerance."""
    import copy

    from vdetr_tpu_torch.models.vdetr import build_model
    from vdetr_tpu_torch.train.engine import Trainer

    cfg = (base or tiny_config()).replace(test_only=True)
    ds = dataset_of(cfg)
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
    log(f"eval step {route} small {cfg.dataset_name} config (test_only) on "
        "card vs CPU plain "
        f"path: nms_keep equal={same} ({int(ref['nms_keep'].sum())} of "
        f"{ref['nms_keep'].numel()} kept), max_abs_err over outputs="
        f"{err:.3e} tol={tol:.0e} (f32 rounding through ~40 layers) -> "
        f"{'ok' if ok else 'FAIL'}")
    return ok


# --------------------------------------------------------------------------
# phase 5: the train step
# --------------------------------------------------------------------------

def train_batch(cfg, B: int, first: int = 0):
    """Synthetic scenes of `cfg`'s dataset with their ground truth (yawed
    boxes and angle labels for SUN RGB-D), as numpy arrays."""
    from vdetr_tpu_torch.data.synthetic import (SyntheticDetectionDataset,
                                                collate)

    ds = SyntheticDetectionDataset(dataset_of(cfg), cfg.num_points,
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
    times), `device: <phase>`, and the device-to-host copies the profiler
    saw in each phase."""
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
    spans, dtoh = {}, {w: 0 for _, _, w in windows}
    for e in dev:
        a, z = e.time_range.start, e.time_range.end
        name = next((w for lo, hi, w in windows if lo <= a < hi), None)
        if name is None:
            continue
        dtoh[name] += "DtoH" in e.name  # a copy to the host
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
    for name, n in dtoh.items():
        t[f"device-to-host copies: {name}"] = n
    return t


def matcher_ms(trainer, batch, gen):
    """Host ms of the criterion's matcher, `solve_costs` between two
    synchronizations: under JV the costs' copy to the host and the JV
    solves; under the auction kernel M's launches on the card."""
    from vdetr_tpu_torch.train.engine import INPUT_KEYS

    crit = trainer.criterion
    b = trainer._to_device(batch)
    with torch.no_grad():
        out = trainer.model({k: b[k] for k in INPUT_KEYS if k in b},
                            generator=gen)
    orig = crit.solve_costs
    spent = {}

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(*args)
        torch.cuda.synchronize()
        spent["ms"] = (time.perf_counter() - t0) * 1e3
        return res

    crit.solve_costs = timed
    try:
        with torch.no_grad():
            crit(out, b)
    finally:
        crit.solve_costs = orig
    return spent["ms"]


def criterion_sync(trainer, batch, gen):
    """The criterion of one step run under
    torch.cuda.set_sync_debug_mode("error"): None when it makes no
    synchronizing call (no device-to-host copy), else the error the first
    such call raised, with the line of the port that made it."""
    import traceback

    from vdetr_tpu_torch.train.engine import INPUT_KEYS

    b = trainer._to_device(batch)
    with torch.no_grad():
        out = trainer.model({k: b[k] for k in INPUT_KEYS if k in b},
                            generator=gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            trainer.criterion(out, b)
        return None
    except RuntimeError as e:
        where = [f"{f.filename.split('vdetr_tpu_torch/')[-1]}:{f.lineno}"
                 for f in traceback.extract_tb(e.__traceback__)
                 if "vdetr_tpu_torch" in f.filename]
        return f"{str(e).splitlines()[0]} at {where[-1:]}"
    finally:
        torch.cuda.set_sync_debug_mode("default")


# kernel function names (as the profiler reports them) -> the port's
# kernels and the part of it; the first match wins; "conv" is the route's
# 3^3 conv (A or H, which share conv_sum_splits_kernel), "conv_bf16" its
# bf16 form's (keyed_conv_bf16 or mapped_conv_bf16, with their sum of the
# live splits), "dW" its weight gradient (D or I, which share dw_kernel,
# the bf16 form's dw_bf16_kernel and dw_sum_splits_kernel); F
# runs the pair kernel, the sum of its key shares' dQ and the dTables
# table kernel
PROFILE_KERNELS = (("neighbour_map_kernel", "keyed_conv_dw", "private map"),
                   ("dw_rulebook_kernel", "dW", "rulebook"),
                   ("conv_sum_splits_kernel", "conv", "split sums"),
                   ("conv_sum_live_splits_kernel", "conv_bf16", "split sums"),
                   ("keyed_conv_bf16_kernel", "keyed_conv_bf16", "conv"),
                   ("mapped_conv_bf16_kernel", "mapped_conv_bf16", "conv"),
                   ("dw_sum_splits_kernel", "dW", "split sums"),
                   ("dw_kernel", "dW", "dW GEMM"),
                   ("dw_bf16_kernel", "dW", "dW GEMM"),
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
                    "table sum"),
                   ("auction_kernel", "auction", "auction"),
                   ("rotated_areas_bwd_kernel", "rotated_iou", "backward"),
                   ("rotated_areas_kernel", "rotated_iou", "forward"))


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
    alias = {"conv": conv, "dW": conv + "_dw", "conv_bf16": conv + "_bf16"}
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


def run_train(cfg, device, power, variants, warm: int = 3, steps: int = 5,
              detail=True):
    """The published model's train step at batch 1 in each variant, name
    -> (conv route, matcher), each with its own model (the same initial weights), optimizer and
    dropout generator (the same seed): `warm` steps, then `steps` timed
    steps, the variants in turn on the same batch (the order
    alternating), so that their medians share the call's conditions.
    Each step's launches are counted. The model, its scenes and its
    criterion are those of `cfg`'s dataset. `detail`: True, or the names
    of the variants that take every per-variant analysis; the others take
    only two whole steps bit for bit and the profiled step (no phase
    breakdowns, matcher timing, sync check or gradient spread)."""
    from vdetr_tpu_torch.tools.determinism import grad_spread, step_twice
    from vdetr_tpu_torch.train.engine import Trainer

    ds = dataset_of(cfg)
    names = list(variants)
    cfgs = {n: cfg.replace(matcher_impl=m) for n, (_, m) in variants.items()}
    trainers = {n: Trainer(cfgs[n], published_model(cfg, device, route), ds,
                           steps_per_epoch=1000, device=device)
                for n, (route, _) in variants.items()}
    expected = {n: expected_launches(tr.model, cfgs[n], train=True)
                for n, tr in trainers.items()}
    gens = {n: torch.Generator(device=device).manual_seed(SEED)
            for n in names}
    counters = launch_counters()
    batches = [train_batch(cfg, 1, first=i) for i in range(warm + steps)]
    ok, launches = True, {}
    times = {n: [] for n in names}
    all_times = {n: [] for n in names}
    peak = {n: 0.0 for n in names}
    for i, batch in enumerate(batches):
        for name in (names if i % 2 == 0 else names[::-1]):
            trainer = trainers[name]
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats(device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, parts = trainer.train_step(batch, gens[name])
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            counts = {k: fn.launches for k, fn in counters.items()}
            peak[name] = max(
                peak[name], torch.cuda.max_memory_allocated(device) / 2 ** 30)
            nonfinite = grads_finite(trainer.model)
            step_ok = (math.isfinite(loss) and not nonfinite
                       and counts == expected[name])
            ok &= step_ok
            all_times[name].append(dt)
            if i == 0:
                launches[name] = counts
            if i >= warm:
                times[name].append(dt)
            log(f"train {cfg.dataset_name} {name} step {i}"
                f"{' (warm)' if i < warm else ''}: "
                f"loss {loss:.4f}, {dt:.1f} ms, grads "
                f"{'finite' if not nonfinite else nonfinite[:3]}, launches "
                + fmt_counts(counts, expected[name])
                + f" -> {'ok' if step_ok else 'FAIL'}")
    stats = {}
    for name, trainer in trainers.items():
        matcher = cfgs[name].matcher_impl
        med = statistics.median(times[name])
        log(f"train {cfg.dataset_name} {name} B=1 N={cfg.num_points} "
            f"matcher={matcher}: "
            f"median {med:.1f} ms/step over {len(times[name])} steps after "
            f"{warm} warm, in turn with the other variants "
            f"[{', '.join(f'{t:.1f}' for t in times[name])}]; all steps "
            f"[{', '.join(f'{t:.1f}' for t in all_times[name])}]; peak "
            f"memory {peak[name]:.2f} GiB (every variant's weights and "
            f"optimizer states resident); card {power}")
        stats[name] = dict(matcher=matcher, ms_per_step=med,
                           steps=times[name], all_steps=all_times[name],
                           peak_gib=peak[name])
        if detail is not True and name not in detail:
            differ, count = step_twice(trainer, batches[1])
            log(f"train {cfg.dataset_name} {name} two whole steps from the "
                f"same state, batch and seed: {len(differ)} of {count} "
                f"parameters differ {differ[:5]} -> "
                f"{'ok' if not differ else 'FAIL'}")
            ok &= not differ
            stats[name]["step_twice_differing"] = differ
            prof = profile_step(trainer, batches[2], gens[name])
            prof["busy_share_of_median_step"] = prof["device_busy_ms"] / med
            stats[name]["profile"] = prof
            log(f"train {cfg.dataset_name} {name} step under torch.profiler:"
                f" device busy {prof['device_busy_ms']:.1f} ms = "
                f"{100 * prof['busy_share_of_median_step']:.1f}% of the "
                f"median step; per port kernel (ms, launches): "
                + "; ".join(f"{k} {v['ms']:.2f} ({v['launches']})"
                            for k, v in sorted(prof["by_kernel"].items())))
            continue
        brk = step_breakdown(trainer, batches[1], gens[name])
        brk[f"matcher alone ({matcher}: "
            + ("cost copy and JV on the host" if matcher == "jv"
               else "kernel M on the card") + ")"] = matcher_ms(
            trainer, batches[1], gens[name])
        log(f"train {cfg.dataset_name} {name} step breakdown (ms; host clock per phase, each "
            "ended by a sync; the backward's stream spans between CUDA "
            "events, which include the host's gaps): " + "; ".join(
                f"{k} {v:.1f}" for k, v in brk.items()))
        sync = criterion_sync(trainer, batches[1], gens[name])
        sync_ok = sync is None if matcher == "auction" else True
        ok &= sync_ok
        log(f"train {cfg.dataset_name} {name} criterion under set_sync_debug_mode('error'): "
            + ("no synchronizing call (no device-to-host copy)"
               if sync is None else f"synchronizes: {sync}")
            + (" -> ok" if sync_ok else " -> FAIL"))
        dev_brk = step_breakdown(trainer, batches[1], gens[name],
                                 profiled=True)
        copies = dev_brk["device-to-host copies: criterion incl. matcher"]
        ok &= copies == 0 or matcher == "jv"
        log(f"train {cfg.dataset_name} {name} step breakdown under torch.profiler (ms; "
            "'device': the union of the phase's device intervals, 'device "
            "kernel sum': their sum; host clock with the profiler on; "
            "device-to-host copies counted): " + "; ".join(
                f"{k} {v:.1f}" for k, v in dev_brk.items())
            + f" -> the criterion's copies to the host: {copies} "
            + ("(JV's)" if matcher == "jv" else
               "(ok)" if copies == 0 else "(FAIL)"))
        spread = grad_spread(trainer, batches[1])
        repeat_ok = not spread["differing"] and all(
            v["max_abs_diff"] == 0 for v in spread["groups"].values())
        log(f"train {cfg.dataset_name} {name} run-to-run gradient spread (two backwards from "
            "the same state, batch and seed; max |g1 - g2| / max |g1| per "
            "parameter group, tolerance 0): " + "; ".join(
                f"{k} {v['rel']:.2e}" for k, v in spread["groups"].items())
            + f"; {len(spread['differing'])} parameters differ "
            f"{[n for n, _ in spread['differing'][:5]]} -> "
            f"{'ok' if repeat_ok else 'FAIL'}")
        differ, count = step_twice(trainer, batches[1])
        log(f"train {cfg.dataset_name} {name} two whole steps (clip and AdamW included) from "
            f"the same state, batch and seed: {len(differ)} of {count} "
            f"parameters differ {differ[:5]} -> "
            f"{'ok' if not differ else 'FAIL'}")
        ok &= repeat_ok and not differ
        stats[name].update(breakdown=brk,
                           breakdown_profiled=dev_brk,
                           criterion_sync=sync,
                           grad_spread=spread["groups"],
                           grad_spread_differing=spread["differing"],
                           step_twice_differing=differ)
        prof = profile_step(trainer, batches[2], gens[name])
        prof["busy_share_of_median_step"] = prof["device_busy_ms"] / med
        stats[name]["profile"] = prof
        log(f"train {cfg.dataset_name} {name} step under torch.profiler: {prof['wall_ms']:.1f}"
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
    # the same batch in each variant: the paired difference against the
    # first cancels the scene-to-scene variation of the step
    a = names[0]
    for b in names[1:]:
        diff = [y - x for x, y in zip(times[a], times[b])]
        stats[f"{b} minus {a} ms"] = diff
        log(f"train {cfg.dataset_name} {b} minus {a}, paired by step: "
            "median "
            f"{statistics.median(diff):.1f} ms ["
            + ", ".join(f"{d:.1f}" for d in diff) + "]")
    return ok, launches, stats


def small_train_config(base=None):
    """The small config (dropout 0, JV) of the card-against-CPU steps."""
    return (base or tiny_config()).replace(
        voxel_size=0.05, num_points=1024, nqueries=32, repeat_num=2,
        matcher_impl="jv", dec_dropout=0.0, mlp_dropout=0.0,
        warm_lr_epochs=0, max_epoch=10, base_lr=1e-3)


# a train step on the card against the same step on the CPU
TRAIN_TOL = {"loss": 1e-4, "grads": 1e-3, "worst": 5e-2, "updates": 1e-3}


def train_errors(ref, got, before):
    """The errors of a train step `got` against `ref`, each (loss,
    {name: (gradient, parameter after the step)}) on the CPU, from the
    parameters `before`: the loss's relative error, the gradients'
    relative L2 error, the worst tensor's max error over its max (of the
    tensors that are not rounding noise), and the updates' relative L2
    error where the gradient is not rounding noise (Adam's first step
    moves those by +-lr on the noise's sign)."""
    (l_ref, p_ref), (l_got, p_got) = ref, got
    g_ref = torch.cat([g.flatten() for g, _ in p_ref.values()])
    g_got = torch.cat([p_got[n][0].flatten() for n in p_ref])
    top = float(g_ref.abs().max())
    u_ref, u_got = [], []
    for n, (g, p) in p_ref.items():
        keep = g.abs() > 1e-6 * top
        u_ref.append((p - before[n])[keep])
        u_got.append((p_got[n][1] - before[n])[keep])
    u_ref, u_got = torch.cat(u_ref), torch.cat(u_got)
    return {"loss": abs(l_got - l_ref) / abs(l_ref),
            "grads": float((g_got - g_ref).norm() / g_ref.norm()),
            "worst": max(float((p_got[n][0] - g).abs().max()
                               / g.abs().max().clamp(min=1e-30))
                         for n, (g, _) in p_ref.items()
                         if float(g.abs().max()) > 1e-6 * top),
            "updates": float((u_got - u_ref).norm() / u_ref.norm())}


def fmt_train_errors(err, ref_loss, got_loss) -> str:
    return (f"loss {got_loss:.6f} vs {ref_loss:.6f} (rel err "
            f"{err['loss']:.2e}, tol {TRAIN_TOL['loss']:.0e}); gradients "
            f"rel L2 err {err['grads']:.2e} (tol {TRAIN_TOL['grads']:.0e}), "
            f"worst tensor {err['worst']:.2e} of its max (tol "
            f"{TRAIN_TOL['worst']:.0e}); updates rel L2 err "
            f"{err['updates']:.2e} (tol {TRAIN_TOL['updates']:.0e})")


TRAIN_TOL_REASON = (
    "  tolerance reason: f32 sums in other orders (~1e-6 relative per "
    "op) through ~80 layers of forward and backward; a ReLU input "
    "within rounding of 0 may take the other one-sided derivative on "
    "the card, which moves a few entries of some tensors by ~1% of "
    "their largest: hence the tensor-wise 5e-2 and the global 1e-3")


def check_small_train_against_cpu(device, route, base=None):
    """One train step of a small model (dropout 0) on `route` (`base`: a
    small config of another dataset) on the card against the same step on
    the CPU through the plain versions: same weights, same batch."""
    import copy

    from vdetr_tpu_torch.models.vdetr import build_model
    from vdetr_tpu_torch.train.engine import Trainer

    cfg = small_train_config(base)
    ds = dataset_of(cfg)
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
    err = train_errors(res["cpu"], res["card"], before)
    ok = all(err[k] <= TRAIN_TOL[k] for k in TRAIN_TOL)
    log(f"train {route} step small {cfg.dataset_name} config on card vs CPU "
        "plain path: " + fmt_train_errors(err, res["cpu"][0], res["card"][0])
        + f" -> {'ok' if ok else 'FAIL'}")
    log(TRAIN_TOL_REASON)
    return ok


def matcher_inputs(cfg, device, B: int):
    """The matcher's inputs of one published train step at batch B: each
    shape group's (kind, costT, n_valid, repeat), captured from the
    criterion's calls into `ops/hungarian.py` after a train-mode forward
    of the published model (keyed, seeded random weights) on synthetic
    scenes."""
    import vdetr_tpu_torch.train.criterion as crit_mod
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.train.engine import INPUT_KEYS, Trainer

    trainer = Trainer(cfg, published_model(cfg, device, "keyed"),
                      ScannetDatasetConfig(), steps_per_epoch=1000,
                      device=device)
    b = trainer._to_device(train_batch(cfg, B))
    seen = []
    plain, capacity = crit_mod.auction, crit_mod.auction_capacity

    def take_plain(cost, n_valid, **kw):
        seen.append(("plain", cost.float().contiguous(), n_valid.clone(),
                     1))
        return plain(cost, n_valid, **kw)

    def take_capacity(cost, n_valid, repeat, **kw):
        seen.append(("capacity", cost.float().contiguous(), n_valid.clone(),
                     repeat))
        return capacity(cost, n_valid, repeat, **kw)

    crit_mod.auction, crit_mod.auction_capacity = take_plain, take_capacity
    try:
        trainer.model.train()
        with torch.no_grad():
            out = trainer.model({k: b[k] for k in INPUT_KEYS if k in b},
                                generator=torch.Generator(
                                    device=device).manual_seed(SEED))
            trainer.criterion(out, b)
    finally:
        crit_mod.auction, crit_mod.auction_capacity = plain, capacity
    return seen


def auction_edge_cases(device):
    """Kernel M's edges at the published widths (1024 proposals, 64 GT
    slots, repeat 5): exact ties (costs on a grid of 3 values), every GT
    row duplicated 5 times (the plain auction's bidding wars), and a
    capacity problem that runs to max_iters (more GT copies than genuine
    proposals: the copies left over bid on 1e6 dummy columns)."""
    rng = np.random.RandomState(SEED)

    def tiled(base, repeat, slots):
        g, m = base.shape
        cost = np.full((slots * repeat, m), 1e6, np.float32)
        for d in range(repeat):
            cost[d * g:(d + 1) * g] = base
        return cost

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    ties = np.stack([tiled(np.round(rng.rand(g, 1024) * 2).astype(
        np.float32), 5, 64) for g in (20, 7, 40, 3)])
    plain_ties = np.full((4, 64, 1024), 1e6, np.float32)
    for b, g in enumerate((20, 7, 40, 3)):
        plain_ties[b, :g] = np.round(rng.rand(g, 1024) * 2)
    dup = np.tile((rng.randn(12, 1024) * 2).astype(np.float32), (5, 1))
    cut = np.full((1, 320, 320), 1e6, np.float32)
    cut[0, :150, :64] = tiled(rng.rand(30, 64).astype(np.float32), 5,
                              30)[:, :64]
    return [("capacity ties", t(ties), t(np.array([100, 35, 200, 15])), 5),
            ("plain ties", t(plain_ties), t(np.array([20, 7, 40, 3])), 1),
            ("plain duplicated rows", t(dup[None]), t(np.array([60])), 1),
            ("capacity to max_iters", t(cut), t(np.array([150])), 5)]


def auction_work(cost, n_valid, repeat, rounds):
    """(bytes, flops) kernel M must spend on these inputs: the valid rows
    read once (classes under the capacity auction) and col4row written;
    each round a compare and a subtract per valid row and column."""
    P, n, m = cost.shape
    rows = (n_valid // repeat) if repeat > 1 else n_valid
    rows = rows.clamp(max=n // repeat if repeat > 1 else n).double().cpu()
    nbytes = float(rows.sum()) * m * 4 + P * n * 4 + P * 4
    flops = float((rows * rounds.double().cpu()).sum()) * m * 2
    return nbytes, flops


def check_auction(cfg, device, power):
    """Kernel M against its plain version on the card, col4row and rounds
    bit for bit: the matcher inputs of the published criterion at B = 1
    and 4 (every job, grouped by shape as one step launches them), then
    the edge cases. The B = 1 groups' launch times (CUDA events), their
    plain versions' and their bounds make the kernel's row."""
    from vdetr_tpu_torch.ops.hungarian import (auction_capacity_plain,
                                               auction_launch, auction_plain)
    from vdetr_tpu_torch.tools.ab_kernels import kernel_device_ms

    cases = []
    for B in (1, 4):
        for kind, cost, nv, rep in matcher_inputs(cfg, device, B):
            cases.append((f"criterion B={B} {kind} {tuple(cost.shape)}",
                          cost, nv, rep, B))
    cases += [c + (None,) for c in auction_edge_cases(device)]
    ok, rows, main = True, [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                "bytes": 0.0, "flops": 0.0, "device_ms": 0.0}
    for name, cost, nv, rep, B in cases:
        got, rounds = auction_launch(cost, nv, rep)
        if rep > 1:
            want, want_rounds = auction_capacity_plain(cost, nv, rep)
        else:
            want, want_rounds = auction_plain(cost, nv)
        torch.cuda.synchronize()
        same = torch.equal(got, want) and torch.equal(rounds.long(),
                                                      want_rounds)
        err = float((got.long() - want.long()).abs().max())
        ok &= same
        most = max(int(rounds.max()), 1)
        t_k = time_ms(lambda: auction_launch(cost, nv, rep),
                      reps=20 if most < 100 else 3)
        t_d = kernel_device_ms(lambda: auction_launch(cost, nv, rep), "M",
                               reps=5 if most < 100 else 2)
        t_p = time_ms((lambda: auction_capacity_plain(cost, nv, rep))
                      if rep > 1 else (lambda: auction_plain(cost, nv)),
                      reps=1, warmup=0)
        nbytes, flops = auction_work(cost, nv, rep, rounds)
        bound, by = bound_ms(nbytes, flops)
        # the problems of a launch run side by side: a round is the
        # device time over the most rounds a problem ran
        us_round = 1e3 * t_d / most
        rows.append(dict(case=name, problems=int(cost.shape[0]),
                         shape=list(cost.shape), repeat=rep,
                         rounds=rounds.tolist(), equal=same,
                         max_abs_err=err, ms=t_k, device_ms=t_d,
                         us_per_round=us_round, plain_ms=t_p,
                         bound_ms=bound, bound_by=by))
        log(f"auction (M) {name}: col4row and rounds "
            f"{'bit-equal' if same else 'DIFFER'} to the plain version "
            f"(max |diff| {err:.0f}, tolerance 0); rounds "
            f"{rounds.tolist()[:12]}{' ...' if len(rounds) > 12 else ''};"
            f" kernel {t_k:.4f} ms (CUDA events), device {t_d:.4f} ms a "
            f"launch ({us_round:.2f} us a round) beside its bound "
            f"{bound:.6f} ms ({by}), plain {t_p:.2f} ms; card {power}")
        if B == 1:
            main["ms"] += t_k
            main["device_ms"] += t_d
            main["plain_ms"] += t_p
            main["bytes"] += nbytes
            main["flops"] += flops
    main["bound_ms"], main["bound_by"] = bound_ms(main["bytes"],
                                                  main["flops"])
    log(f"auction (M) per published train step at B=1 (2 launches, one a "
        f"shape group: the 8 repeated jobs' capacity auction and the "
        f"bilabel aux0's plain auction): "
        f"kernel {main['ms']:.4f} ms (CUDA events), device "
        f"{main['device_ms']:.4f} ms beside its bound "
        f"{main['bound_ms']:.6f} ms ({main['bound_by']}), plain "
        f"{main['plain_ms']:.2f} ms; library none -> "
        f"{'ok' if ok else 'FAIL'}")
    return dict(ok=ok, err=max(r["max_abs_err"] for r in rows),
                ms=main["ms"], device_ms=main["device_ms"],
                plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                cases=rows)


# the CLI phase's fabricated scans: train and val counts, vertices a scan
SCAN_TRAIN, SCAN_VAL = 4, 2
SCAN_VERTICES = (150000, 250000)


def write_scannet_scans(root):
    """Fabricated scans in the ScanNet prep layout that
    `data/scannet.py` reads: `{scan}_vert.npy` (x, y, z, r, g, b),
    `{scan}_bbox.npy` (cx, cy, cz, dx, dy, dz, nyu40 id) and the split
    lists. Each scan is a room 4-7 m across holding 6-20 boxes of the
    ScanNet classes near their mean sizes, its vertices on the boxes'
    surfaces, the floor and two walls: `SCAN_VERTICES` (lo, hi) in all."""
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig

    ds = ScannetDatasetConfig()
    rng = np.random.RandomState(SEED)
    names = {"train": [f"scene{i:04d}_00" for i in range(SCAN_TRAIN)],
             "val": [f"scene{i:04d}_00"
                     for i in range(100, 100 + SCAN_VAL)]}
    for name in names["train"] + names["val"]:
        room = np.append(rng.rand(2) * 3 + 4.0, 2.5 + rng.rand() * 0.7)
        nb = rng.randint(6, 21)
        cls = rng.randint(0, ds.num_semcls, nb)
        size = ds.mean_size_arr[cls] * np.exp(rng.randn(nb, 3) * 0.1)
        center = np.stack([rng.rand(nb) * (room[0] - size[:, 0])
                           + size[:, 0] / 2,
                           rng.rand(nb) * (room[1] - size[:, 1])
                           + size[:, 1] / 2, size[:, 2] / 2], 1)
        total = rng.randint(SCAN_VERTICES[0], SCAN_VERTICES[1] + 1)
        area = 2 * (size[:, 0] * size[:, 1] + size[:, 0] * size[:, 2]
                    + size[:, 1] * size[:, 2])
        per_box = np.maximum((0.4 * total * area / area.sum()).astype(int),
                             1)
        parts = []
        for b in range(nb):
            face = rng.randint(0, 6, per_box[b])
            u = rng.rand(per_box[b], 3) - 0.5
            u[np.arange(per_box[b]), face // 2] = np.where(face % 2, 0.5,
                                                           -0.5)
            parts.append(u * size[b] + center[b])
        rest = total - per_box.sum()
        nfloor = rest * 2 // 3
        parts.append(np.stack([rng.rand(nfloor) * room[0],
                               rng.rand(nfloor) * room[1],
                               np.abs(rng.randn(nfloor)) * 0.01], 1))
        nwall = rest - nfloor
        along = rng.rand(nwall) < 0.5
        parts.append(np.stack([np.where(along, rng.rand(nwall) * room[0],
                                        0.01),
                               np.where(along, 0.01,
                                        rng.rand(nwall) * room[1]),
                               rng.rand(nwall) * room[2]], 1))
        xyz = np.concatenate(parts)
        verts = np.concatenate([xyz, rng.rand(len(xyz), 3) * 255], 1)
        boxes = np.concatenate([center, size, ds.nyu40ids[cls][:, None]], 1)
        np.save(os.path.join(root, f"{name}_vert.npy"),
                verts.astype(np.float32))
        np.save(os.path.join(root, f"{name}_bbox.npy"),
                boxes.astype(np.float32))
    for split, scans in names.items():
        with open(os.path.join(root, f"scannetv2_{split}.txt"), "w") as f:
            f.write("\n".join(scans) + "\n")
    return names


def run_cli(device, power, dataset: str = "scannet"):
    """The CLI, `vdetr_tpu_torch.main.main`, at the VDETRConfig defaults
    (auction, 100k points; random cuboid on ScanNet) on fabricated scans
    of `dataset` in a temporary directory (ScanNet's prep layout, or
    VoteNet's SUN RGB-D layout with `--angle_type object_coords`): train one
    epoch with a checkpoint directory (checkpoint, checkpoint_best,
    final_eval.txt/pkl), the launches of that run per kernel; then
    `--test_only --auto_test` on checkpoint_best, whose mAP@0.25 and 0.5
    must equal the final eval's (at --empty_pt_thre 0, so that the test
    pass's empty-box removal keeps every box, as the training loop's
    passes do), and again at the default threshold; then a second epoch
    resumed from the checkpoint. Wall ms of each train step and seconds
    of each eval pass."""
    import pickle
    import shutil
    import tempfile

    from vdetr_tpu_torch import main as cli
    from vdetr_tpu_torch.eval.ap_calculator import APCalculator
    from vdetr_tpu_torch.models.vdetr import build_model
    from vdetr_tpu_torch.train import checkpoint as ckpt_io
    from vdetr_tpu_torch.train import engine

    root = tempfile.mkdtemp(prefix="vdetr_cli_")
    steps, passes, metrics_s = [], [], []
    orig_step, orig_eval = engine.Trainer.train_step, engine.evaluate
    orig_metrics = APCalculator.compute_metrics

    def timed_step(self, *a, **k):
        t0 = time.perf_counter()
        out = orig_step(self, *a, **k)  # ends in the finite-loss sync
        steps.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_eval(*a, **k):
        t0 = time.perf_counter()
        out = orig_eval(*a, **k)
        passes.append(time.perf_counter() - t0)
        return out

    def timed_metrics(self, *a, **k):
        t0 = time.perf_counter()
        out = orig_metrics(self, *a, **k)
        metrics_s.append(time.perf_counter() - t0)
        return out

    engine.Trainer.train_step, engine.evaluate = timed_step, timed_eval
    APCalculator.compute_metrics = timed_metrics
    try:
        t0 = time.perf_counter()
        if dataset == "sunrgbd":
            names = write_sunrgbd_scans(root)
            nverts = [len(np.load(os.path.join(root, split,
                                               f"{n}_pc.npz"))["pc"])
                      for split in names for n in names[split]]
            model_flags = ["--angle_type", "object_coords"]
        else:
            names = write_scannet_scans(root)
            nverts = [len(np.load(os.path.join(root, f"{n}_vert.npy"),
                                  mmap_mode="r"))
                      for n in names["train"] + names["val"]]
            model_flags = []
        write_s = time.perf_counter() - t0
        ckpt = os.path.join(root, "ckpt")
        data = ["--dataset_name", dataset, "--dataset_root_dir", root]
        base = data + model_flags + ["--checkpoint_dir", ckpt]
        counters = launch_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        final = cli.main(base + ["--max_epoch", "1"], device=device)
        train_s = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in counters.items()}
        cfg = cli.config_from_args(cli.make_args_parser().parse_args(
            base + ["--max_epoch", "1"]))
        probe = build_model(cfg, dataset_of(cfg), device=device)
        ntrain, evals = len(names["train"]), 2 * len(names["val"])
        per_step = expected_launches(probe, cfg, train=True)
        per_eval = expected_launches(probe, cfg)
        per_eval["nms"] = 1
        expected = {k: ntrain * per_step[k] + evals * per_eval[k]
                    for k in counts}
        files = all(os.path.exists(os.path.join(ckpt, f)) for f in (
            "checkpoint/state.pt", "checkpoint/header.json",
            "checkpoint_best/state.pt", "final_eval.txt", "final_eval.pkl"))
        with open(os.path.join(ckpt, "final_eval.pkl"), "rb") as f:
            pkl = pickle.load(f)
        pkl_ok = all(pkl[t]["mAP"] == final[t]["mAP"] for t in (0.25, 0.5))
        launches_ok = counts == expected
        log(f"cli {dataset} train: {ntrain} train and {len(names['val'])} "
            f"val fabricated scans of {min(nverts)}-{max(nverts)} points "
            f"(written in {write_s:.1f} s); main(--max_epoch 1) in "
            f"{train_s:.1f} s: train steps "
            f"[{', '.join(f'{t:.1f}' for t in steps)}] ms (median "
            f"{statistics.median(steps):.1f}, B={cfg.batchsize_per_gpu}, "
            f"matcher {cfg.matcher_impl}), eval passes "
            f"[{', '.join(f'{t:.2f}' for t in passes)}] s of eval steps, "
            f"the AP's compute_metrics "
            f"[{', '.join(f'{t:.2f}' for t in metrics_s)}] s; final eval "
            f"mAP@0.25 {final[0.25]['mAP']:.6f} mAP@0.5 "
            f"{final[0.5]['mAP']:.6f}; checkpoint, checkpoint_best, "
            f"final_eval.txt/pkl {'written' if files and pkl_ok else 'MISSING'}"
            f"; launches " + fmt_counts(counts, expected)
            + f" -> {'ok' if files and pkl_ok and launches_ok else 'FAIL'}")
        best = os.path.join(ckpt, "checkpoint_best")
        test = data + ["--test_only", "1", "--auto_test", "1",
                       "--test_ckpt", best]
        n_pass = len(passes)
        again = cli.main(test + ["--empty_pt_thre", "0"], device=device)
        same = all(again[t]["mAP"] == final[t]["mAP"] for t in (0.25, 0.5))
        dflt = cli.main(test, device=device)
        log(f"cli {dataset} --test_only --auto_test on checkpoint_best: "
            "mAP@0.25 "
            f"{again[0.25]['mAP']:.6f} mAP@0.5 {again[0.5]['mAP']:.6f} at "
            f"--empty_pt_thre 0 -> {'equal to' if same else 'DIFFERS from'}"
            f" the final eval; at the default threshold (empty-box removal)"
            f" {dflt[0.25]['mAP']:.6f} / {dflt[0.5]['mAP']:.6f}; eval "
            f"passes [{', '.join(f'{t:.2f}' for t in passes[n_pass:])}] s"
            f" -> {'ok' if same else 'FAIL'}")
        n_steps = len(steps)
        resumed = cli.main(base + ["--max_epoch", "2"], device=device)
        header = ckpt_io.read_header(os.path.join(ckpt, "checkpoint"))
        state = torch.load(os.path.join(ckpt, "checkpoint", "state.pt"),
                           map_location="cpu", weights_only=True)
        resume_ok = (header["epoch"] == 1 and state["step"] == 2 * ntrain
                     and len(steps) - n_steps == ntrain
                     and all(math.isfinite(resumed[t]["mAP"])
                             for t in (0.25, 0.5)))
        log(f"cli {dataset} resume (--max_epoch 2 on the same "
            "checkpoint_dir): "
            f"{len(steps) - n_steps} steps run (epoch 1 only), checkpoint "
            f"at epoch {header['epoch']} step {state['step']}, final eval "
            f"mAP@0.25 {resumed[0.25]['mAP']:.6f} -> "
            f"{'ok' if resume_ok else 'FAIL'}; card {power}")
        ok = files and pkl_ok and launches_ok and same and resume_ok
        return ok, dict(
            scans={"train": ntrain, "val": len(names["val"]),
                   "vertices": nverts},
            train_step_ms=steps, eval_pass_s=passes,
            compute_metrics_s=metrics_s,
            train_step_median_ms=statistics.median(steps),
            final={str(t): float(final[t]["mAP"]) for t in (0.25, 0.5)},
            test_only={str(t): float(again[t]["mAP"]) for t in (0.25, 0.5)},
            launches=counts, expected_launches=expected)
    finally:
        engine.Trainer.train_step, engine.evaluate = orig_step, orig_eval
        APCalculator.compute_metrics = orig_metrics
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 7: SUN RGB-D (oriented boxes) at the published width, kernel R
# --------------------------------------------------------------------------

def sun_config():
    """The slice's configuration: what `python -m vdetr_tpu.main
    --dataset_name sunrgbd --angle_type object_coords` runs, every other
    field at its default (the rotated vertex RPE in C and F)."""
    from vdetr_tpu_torch.config import VDETRConfig

    return VDETRConfig(dataset_name="sunrgbd", angle_type="object_coords")


def sun_tiny_config():
    return tiny_config().replace(dataset_name="sunrgbd",
                                 angle_type="object_coords")


@contextlib.contextmanager
def capture_rotated(seen):
    """Every call of the rotated GIoU's `rotated_intersection_areas` while
    the block runs, appended to `seen` as {rect1, rect2, gate (uint8)}
    and, once the backward has passed it, "grad" (the cotangent kernel R's
    backward received)."""
    import vdetr_tpu_torch.geometry.iou as iou_mod

    real = iou_mod.rotated_intersection_areas

    def take(rect1, rect2, gate):
        out = real(rect1, rect2, gate)
        job = {"rect1": rect1.detach().float().contiguous(),
               "rect2": rect2.detach().float().contiguous(),
               "gate": gate.to(torch.uint8).contiguous()}
        seen.append(job)
        if out.requires_grad:
            out.register_hook(lambda g, job=job: job.__setitem__(
                "grad", g.detach().float().contiguous()))
        return out

    iou_mod.rotated_intersection_areas = take
    try:
        yield seen
    finally:
        iou_mod.rotated_intersection_areas = real


def rotated_inputs(cfg, device, B: int):
    """Kernel R's inputs of one published SUN RGB-D train step at batch B,
    one per criterion job, with the cotangents of its backward: a
    train-mode forward of the published model (keyed, seeded random
    weights) on rotated synthetic scenes, the criterion and the
    backward."""
    from vdetr_tpu_torch.train.engine import INPUT_KEYS, Trainer

    trainer = Trainer(cfg, published_model(cfg, device, "keyed"),
                      dataset_of(cfg), steps_per_epoch=1000, device=device)
    b = trainer._to_device(train_batch(cfg, B))
    trainer.model.train()
    with capture_rotated([]) as seen:
        out = trainer.model({k: b[k] for k in INPUT_KEYS if k in b},
                            generator=torch.Generator(
                                device=device).manual_seed(SEED))
        loss, _ = trainer.criterion(out, b)
        loss.backward()
    return seen


def rotated_edge_cases(device):
    """Kernel R's edge cases, as the rotated GIoU hands them over: 10
    predictions against 6 ground-truth boxes (identical axis-aligned
    boxes; a box inside another; a shared edge; collinear edges; a
    touching corner; zero-size boxes on both sides; a pair the corner-1/3
    gate turns off although it overlaps, a yaw of pi; parallel edges; a
    sliver); two identical rotated boxes, every gate on (`ILL_POSED`);
    and 64 random yawed predictions against 16 boxes near them, with the
    GIoU's gate and with every pair on; a random cotangent on every
    pair."""
    from vdetr_tpu_torch.geometry.boxes import box_parametrization_to_corners
    from vdetr_tpu_torch.geometry.iou import generalized_box3d_iou

    unit = [0, 0, 0, 1, 1, 1, 0]
    gt = [unit, [3, 0, 0, 2, 2, 1, 0.3], [0, 3, 0, 0, 0, 0, 0],
          [6, 6, 0, 1, 1, 1, 0], [-3, -3, 0, 1, 2, 1, 0],
          [-6, 0, 0, 1, 1, 1, 0]]
    preds = [unit, [0, 0, 0, 0.5, 0.5, 0.5, 0], [1, 0, 0, 1, 1, 1, 0],
             [0.5, 0.25, 0, 1, 0.5, 1, 0], [1, 1, 0, 1, 1, 1, 0],
             [0, 0, 0, 0, 0, 0, 0], [0, 0, 0, 1, 1, 1, np.pi],
             [3.125, 0, 0, 2, 2, 1, 0.3], [3.9, 0.9, 0, 0.25, 0.25, 1, 1.0],
             [-3, -3, 0.25, 1, 2, 1, 0.7]]
    same = [[3, 0, 0, 2, 2, 1, 0.3], [-1, 2, 0, 0.7, 1.3, 1, -2.1]]
    rng = np.random.RandomState(SEED)

    def rand(n):
        return np.concatenate([rng.randn(n, 3) * 0.4, rng.rand(n, 3) * 1.5
                               + 0.2, rng.rand(n, 1) * 2 * np.pi - np.pi], 1)

    out = []
    for name, p, g in (("edge cases", preds, gt), (ILL_POSED, same, same),
                       ("random yawed", rand(64), rand(16))):
        t = torch.tensor(np.asarray(p, np.float32)[None], device=device)
        u = torch.tensor(np.asarray(g, np.float32)[None], device=device)
        c1 = box_parametrization_to_corners(t[..., :3], t[..., 3:6],
                                            t[..., 6])
        c2 = box_parametrization_to_corners(u[..., :3], u[..., 3:6],
                                            u[..., 6])
        with capture_rotated([]) as seen, torch.no_grad():
            generalized_box3d_iou(c1, c2, rotated_boxes=True)
        job = seen[0]
        if name == ILL_POSED:
            job["gate"] = torch.ones_like(job["gate"])
        job["grad"] = torch.randn(job["gate"].shape, device=device,
                                  generator=torch.Generator(
                                      device=device).manual_seed(SEED))
        out.append((name, job))
        if name == "random yawed":
            out.append(("random yawed, every pair",
                        dict(job, gate=torch.ones_like(job["gate"]))))
    return out


# identical rotated boxes: each subject vertex lies on a clip line, where
# the strict inside test goes by rounding and a crossing along a collinear
# edge divides by a rounding residue; the area is an artefact of the
# rounding and its gradient has no meaning (~1e7). The forward is held bit
# for bit; the backward to finite values that repeat bit for bit only.
ILL_POSED = "identical rotated boxes (ill-posed)"


def rotated_plain_grad(job, rows: int = 64):
    """d rect1 of sum(grad * areas) by autograd through kernel R's plain
    version, on the rows with a cotangent that reaches a gated pair (the
    other rows' gradient is 0), `rows` rows at a time."""
    from vdetr_tpu_torch.ops.rotated_iou import clip_quad_quad_plain

    r1, r2, gate, g = job["rect1"], job["rect2"], job["gate"].bool(), \
        job["grad"]
    out = torch.zeros_like(r1)
    live = ((g != 0) & gate).any(-1).nonzero()
    for s in range(0, len(live), rows):
        b, q = live[s:s + rows].unbind(1)
        sub = r1[b, q].clone().requires_grad_(True)
        with torch.enable_grad():
            a = clip_quad_quad_plain(sub[:, None], r2[b])
            (torch.where(gate[b, q], a, 0.0) * g[b, q]).sum().backward()
        out[b, q] = sub.grad
    return out


# the backward's tolerance against autograd of the plain version, of the
# largest |d rect1| of the prediction's row (at least 1)
ROTATED_BWD_TOL = 1e-4
ROTATED_BWD_REASON = (
    "the chain rule of each pair in another order than autograd's, with "
    "nvcc's fused multiply-adds in the backward (its forward replay rounds "
    "alone, so it takes the forward's branches); ~100 f32 operations a "
    "pair, summed over a row's columns in column order")


def rotated_work(job):
    """(forward bytes, forward flops, backward bytes, backward flops) of
    kernel R on `job`: each input read once and each output written once;
    the clips' flops (`clip_flops`) over the gated pairs, and over the
    gated pairs with a nonzero cotangent three times (the replay and its
    reverse); the gated share of the pairs."""
    from vdetr_tpu_torch.ops.rotated_iou import (clip_flops,
                                                 clip_quad_quad_plain)

    r1, r2, gate = job["rect1"], job["rect2"], job["gate"].bool()
    with torch.no_grad():
        _, work = clip_quad_quad_plain(r1[:, :, None], r2[:, None],
                                       work=True)
    flops = clip_flops(work).double()
    fwd_flops = float(flops[gate].sum())
    live = gate & (job["grad"] != 0)
    bwd_flops = 3 * float(flops[live].sum())
    base = nbytes(r1, r2, job["gate"])
    return (base + gate.numel() * 4, fwd_flops,
            base + nbytes(job["grad"]) + r1.numel() * 4, bwd_flops,
            float(gate.float().mean()), int(live.sum()))


def check_rotated_iou(cfg, device, power):
    """Kernel R against its plain version on the card: the forward bit for
    bit, the backward against autograd of the plain version
    (`ROTATED_BWD_TOL`) and bit for bit from a second launch; on every job
    of the published SUN RGB-D criterion at B = 1 and 4 (the cotangents
    of that step's backward), then the edge cases. Per case the times by
    CUDA events, the plain versions', the bound and the gated share; the
    B = 1 step's sums (one forward and one backward launch a job) and the
    device ms of its launches make the kernel's row."""
    from vdetr_tpu_torch.ops.rotated_iou import (rotated_areas_bwd_launch,
                                                 rotated_areas_launch,
                                                 rotated_areas_plain)
    from vdetr_tpu_torch.tools import graph_ms

    cases = []
    for B in (1, 4):
        for j, job in enumerate(rotated_inputs(cfg, device, B)):
            cases.append((f"criterion B={B} job {j} "
                          f"{tuple(job['gate'].shape)}", job, B))
        torch.cuda.empty_cache()
    cases += [(name, job, None) for name, job in rotated_edge_cases(device)]
    ok, rows = True, []
    main = {k: 0.0 for k in ("ms", "bwd_ms", "device_ms", "plain_ms",
                             "plain_bwd_ms", "bound_ms", "pairs", "gated")}
    for name, job, B in cases:
        r1, r2, gate, g = (job[k] for k in ("rect1", "rect2", "gate",
                                            "grad"))
        got = rotated_areas_launch(r1, r2, gate)
        with torch.no_grad():
            want = rotated_areas_plain(r1, r2, gate.bool())
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        err = float((got - want).abs().nan_to_num(float("inf")).max())
        d1 = rotated_areas_bwd_launch(r1, r2, gate, g)
        d1b = rotated_areas_bwd_launch(r1, r2, gate, g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = rotated_plain_grad(job)
        torch.cuda.synchronize()
        t_pb = (time.perf_counter() - t0) * 1e3
        repeat = torch.equal(d1.view(torch.int32), d1b.view(torch.int32))
        # where autograd of the plain version overflows (a crossing along
        # a collinear edge: identical rotated boxes), only the forward's
        # bits are compared
        fin = torch.isfinite(ref)
        overflow = int((~fin).sum())
        row_scale = torch.where(fin, ref.abs(), 0.0).amax((-2, -1),
                                                          keepdim=True)
        excess = torch.where(fin, (d1 - ref).abs().nan_to_num(float("inf"))
                             / row_scale.clamp(min=1.0), 0.0)
        rel = float(excess.max())
        gerr = float(torch.where(fin, (d1 - ref).abs(), 0.0).nan_to_num(
            float("inf")).max())
        scale = float(row_scale.max())
        finite = bool(torch.isfinite(d1[fin]).all())
        case_ok = same and repeat and finite and (
            rel <= ROTATED_BWD_TOL or name == ILL_POSED)
        ok &= case_ok
        t_f = time_ms(lambda: rotated_areas_launch(r1, r2, gate), reps=10)
        t_b = time_ms(lambda: rotated_areas_bwd_launch(r1, r2, gate, g),
                      reps=10)
        with torch.no_grad():
            t_p = time_ms(lambda: rotated_areas_plain(r1, r2, gate.bool()),
                          reps=1, warmup=0)
        fb, ff, bb, bf, share, live = rotated_work(job)
        b_f, by_f = bound_ms(fb, ff)
        b_b, by_b = bound_ms(bb, bf)
        rec = dict(case=name, shape=list(gate.shape), forward_bit_equal=same,
                   max_abs_err=err, backward_max_abs_err=gerr,
                   backward_max_rel_err=rel, backward_largest=scale,
                   backward_repeats=repeat,
                   ms=t_f, bwd_ms=t_b, plain_ms=t_p, plain_bwd_ms=t_pb,
                   bound_ms=b_f, bound_by=by_f, bwd_bound_ms=b_b,
                   bwd_bound_by=by_b, gated_share=share,
                   pairs_with_cotangent=live, plain_grad_overflow=overflow)
        # device ms a launch: a launch is shorter than its wrapper's
        # Python, and torch.profiler caught few of these launches here
        d_f = graph_ms(lambda: rotated_areas_launch(r1, r2, gate))
        d_b = graph_ms(lambda: rotated_areas_bwd_launch(r1, r2, gate, g))
        rec["device_ms"], rec["bwd_device_ms"] = d_f, d_b
        if B == 1:
            main["device_ms"] += d_f + d_b
            for k in ("ms", "bwd_ms", "plain_ms", "plain_bwd_ms"):
                main[k] += rec[k]
            main["bound_ms"] += b_f + b_b
            main["pairs"] += gate.numel()
            main["gated"] += share * gate.numel()
        rows.append(rec)
        log(f"rotated_iou (R) {name}: forward "
            f"{'bit-equal' if same else 'DIFFERS'} to the plain version "
            f"(max |diff| {err:.3e}, tolerance 0); backward max |diff| "
            f"{gerr:.3e}, {rel:.2e} of its row's largest |d rect1| (at "
            f"least 1; the largest {scale:.3e}) against autograd of the "
            f"plain version (tol "
            f"{'none: ill-posed' if name == ILL_POSED else f'{ROTATED_BWD_TOL:.0e}'}"
            "), "
            f"{'repeats bit for bit' if repeat else 'DIFFERS launch to launch'}"
            f"{'' if finite else ', NOT FINITE'}"
            f"{f' ({overflow} entries of the plain gradient overflow)' if overflow else ''}"
            f"; gated {100 * share:.1f}% "
            f"of {gate.numel()} pairs, {live} with a cotangent; forward "
            f"{t_f:.4f} ms (CUDA events), device {d_f:.4f} ms a launch "
            f"(a CUDA graph's back-to-back launches) beside its bound "
            f"{b_f:.6f} ({by_f}), plain {t_p:.2f}; "
            f"backward {t_b:.4f} ms, device {d_b:.4f} ms a launch beside "
            f"its bound {b_b:.6f} ({by_b}), plain autograd {t_pb:.1f} -> "
            f"{'ok' if case_ok else 'FAIL'}")
        del got, want, d1, d1b, ref
    log("  tolerance reason (backward): " + ROTATED_BWD_REASON)
    share = main["gated"] / max(main["pairs"], 1)
    jobs = sum(B == 1 for _, _, B in cases)
    log(f"rotated_iou (R) per published SUN RGB-D train step at B=1 (one "
        f"forward and one backward launch each of its {jobs} jobs): kernel {main['ms']:.4f} + {main['bwd_ms']:.4f} ms "
        f"(CUDA events), device {main['device_ms']:.4f} ms, plain "
        f"{main['plain_ms']:.1f} + {main['plain_bwd_ms']:.1f} ms, bound "
        f"{main['bound_ms']:.6f} ms; the gate passes {100 * share:.2f}% of "
        f"the pairs; library none; card {power} -> "
        f"{'ok' if ok else 'FAIL'}")
    return dict(ok=ok, err=max(r["max_abs_err"] for r in rows),
                ms=main["ms"] + main["bwd_ms"], fwd_ms=main["ms"],
                bwd_ms=main["bwd_ms"], device_ms=main["device_ms"],
                plain_ms=main["plain_ms"] + main["plain_bwd_ms"],
                bound_ms=main["bound_ms"],
                bound_by=_dominant([r for r in rows]),
                # the ill-posed case's backward is held to nothing
                backward_max_rel_err=max(r["backward_max_rel_err"]
                                         for r in rows
                                         if r["case"] != ILL_POSED),
                gated_share=share, cases=rows)


def run_iou_types(cfg, device, power, steps: int = 2):
    """The published SUN RGB-D train step (keyed, the auction) under
    `iou_type` "diou" and "iou" (the differentiable rotated DIoU / IoU,
    plain torch), after one warm step: loss and gradients finite, ms of
    each step, the criterion's host ms (a synced phase of
    `step_breakdown`) and its device ms (the same under torch.profiler),
    and peak memory."""
    from vdetr_tpu_torch.train.engine import Trainer

    ok, res = True, {}
    batches = [train_batch(cfg, 1, first=i) for i in range(steps + 1)]
    for iou_type in ("diou", "iou"):
        c = cfg.replace(iou_type=iou_type)
        tr = Trainer(c, published_model(c, device, "keyed"), dataset_of(c),
                     steps_per_epoch=1000, device=device)
        gen = torch.Generator(device=device).manual_seed(SEED)
        times, finite = [], True
        torch.cuda.reset_peak_memory_stats(device)
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = tr.train_step(batch, gen)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
            finite &= math.isfinite(loss) and not grads_finite(tr.model)
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        brk = step_breakdown(tr, batches[0], gen)
        crit = brk["criterion incl. matcher"]
        dev = step_breakdown(tr, batches[0], gen, profiled=True)[
            "device: criterion incl. matcher"]
        ok &= finite
        res[iou_type] = dict(step_ms=times, criterion_ms=crit,
                             criterion_device_ms=dev, peak_gib=peak,
                             finite=finite)
        log(f"train sunrgbd iou_type={iou_type} keyed B=1: steps "
            f"[{', '.join(f'{t:.1f}' for t in times)}] ms after a warm one,"
            f" the criterion {crit:.1f} host ms (synced phase), {dev:.1f} "
            "device ms (under torch.profiler), peak memory "
            f"{peak:.2f} GiB, loss and gradients "
            f"{'finite' if finite else 'NOT FINITE'}; card {power} -> "
            f"{'ok' if finite else 'FAIL'}")
        del tr
        torch.cuda.empty_cache()
    return ok, res


# the SUN RGB-D CLI's fabricated scans: points a scan (VoteNet's SUN RGB-D
# extraction keeps 50k points of each depth image), boxes a scan
SUN_POINTS = 50000
SUN_BOXES = (3, 12)


def write_sunrgbd_scans(root):
    """Fabricated scans in VoteNet's SUN RGB-D layout, which
    `data/sunrgbd.py` reads: `<split>/<id>_pc.npz` with `pc` (x, y, z and
    colour centred on 0, `SUN_POINTS` points) and `<split>/<id>_bbox.npy`
    (cx, cy, cz, dx, dy, dz, heading, class): a room 3-5 m across whose
    3-12 boxes of the 10 classes, near their mean sizes and yawed, hold
    60% of the points on their surfaces, the floor and a wall the rest."""
    from vdetr_tpu_torch.data.dataset_config import SunrgbdDatasetConfig

    ds = SunrgbdDatasetConfig()
    rng = np.random.RandomState(SEED)
    names = {"train": [f"{i:06d}" for i in range(1, SCAN_TRAIN + 1)],
             "val": [f"{i:06d}" for i in range(5001, 5001 + SCAN_VAL)]}
    for split, ids in names.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for sid in ids:
            room = rng.rand(2) * 2 + 3.0
            nb = rng.randint(SUN_BOXES[0], SUN_BOXES[1] + 1)
            cls = rng.randint(0, ds.num_semcls, nb)
            size = ds.mean_size_arr[cls] * np.exp(rng.randn(nb, 3) * 0.1)
            yaw = rng.rand(nb) * 2 * np.pi - np.pi
            center = np.stack([(rng.rand(nb) - 0.5) * room[0],
                               rng.rand(nb) * room[1] + 1.0,
                               size[:, 2] / 2], 1)
            per_box = int(0.6 * SUN_POINTS) // nb
            parts = []
            for b in range(nb):
                face = rng.randint(0, 6, per_box)
                u = rng.rand(per_box, 3) - 0.5
                u[np.arange(per_box), face // 2] = np.where(face % 2, 0.5,
                                                            -0.5)
                c, s = np.cos(yaw[b]), np.sin(yaw[b])
                rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
                parts.append((u * size[b]) @ rot.T + center[b])
            rest = SUN_POINTS - per_box * nb
            floor = rest // 2
            parts.append(np.stack([(rng.rand(floor) - 0.5) * room[0],
                                   rng.rand(floor) * room[1] + 1.0,
                                   np.abs(rng.randn(floor)) * 0.01], 1))
            wall = rest - floor
            parts.append(np.stack([(rng.rand(wall) - 0.5) * room[0],
                                   np.full(wall, room[1] + 1.0),
                                   rng.rand(wall) * 2.5], 1))
            xyz = np.concatenate(parts)
            pc = np.concatenate([xyz, rng.rand(len(xyz), 3) - 0.5], 1)
            boxes = np.concatenate([center, size, yaw[:, None],
                                    cls[:, None]], 1)
            np.savez(os.path.join(root, split, f"{sid}_pc.npz"),
                     pc=pc.astype(np.float32))
            np.save(os.path.join(root, split, f"{sid}_bbox.npy"),
                    boxes.astype(np.float32))
    return names


# --------------------------------------------------------------------------
# phase 9: data parallel (one process a rank, spawned under a time limit)
# --------------------------------------------------------------------------

# a rank's collectives wait at most this long (NCCL's watchdog or gloo
# then raises); a group of ranks at most DP_GROUP_S s, its start included
DP_COLLECTIVE_S = 240
DP_GROUP_S = 420
# (a)'s steps: two compared bit for bit, the rest timed in turns (8 until
# phase 11 needed the time)
DP_WORLD1_STEPS = 6


def dp_spec(tmp, name, world, backend, device, cfg, batches, **kw):
    import datetime

    return dict(world=world, init_method=f"file://{tmp}/{name}",
                backend=backend, device=device, cfg=cfg, batches=batches,
                weights_seed=SEED,
                timeout=datetime.timedelta(seconds=DP_COLLECTIVE_S), **kw)


def fmt_collectives(c) -> str:
    return (f"{c['count']} collectives {c['by_name']}, host ms "
            f"{c['host_ms']:.2f}, NCCL kernels {c['device_kernels']} of "
            f"{c['device_ms']:.3f} device ms")


def dp_world1(cfg, tmp, power):
    """(a) World size 1 on NCCL: the published model (keyed, B = 1, the
    auction, dropout on) under DDP and sync-BN against the plain
    `Trainer` in one process: two whole steps from one state leave the
    same parameters and running statistics bit for bit, with the same
    losses and launches; then their steps in turns, timed; then one step
    of each under torch.profiler, its collectives counted (the plain
    step's must be 0)."""
    from vdetr_tpu_torch.models.norm import BatchNorm1d
    from vdetr_tpu_torch.tools import run_ranks
    from vdetr_tpu_torch.tools.dp_step import plain_vs_world1

    batches = [train_batch(cfg, 1, first=i) for i in range(DP_WORLD1_STEPS)]
    r = run_ranks(plain_vs_world1, 1, dp_spec(
        tmp, "a", 1, "nccl", "cuda:0", cfg, batches), DP_GROUP_S)[0]
    norms = sum(isinstance(m, BatchNorm1d) for m in
                published_model(cfg, "cpu", "keyed").modules())
    coll = r["collectives"]
    ok = (not r["state_differs"] and r["losses_equal"]
          and r["launches_equal"] and coll["plain"]["count"] == 0
          and coll["data parallel"]["count"] >= 2 * norms + 2)
    log(f"data parallel (a) world 1 on NCCL, published model, keyed, B=1, "
        f"auction, dropout on: two whole steps against the plain Trainer: "
        f"{len(r['state_differs'])} of {r['state_compared']} parameters "
        f"and buffers differ {r['state_differs'][:5]}; losses "
        f"{'equal' if r['losses_equal'] else 'differ'} "
        f"{[s[0] for s in r['steps']['plain']]} vs "
        f"{[s[0] for s in r['steps']['data parallel']]}; launches "
        f"{'equal' if r['launches_equal'] else 'differ'}")
    log(f"data parallel (a) medians in turns over {len(batches) - 2} steps: "
        + "; ".join(f"{k} {v:.1f} ms [" + ", ".join(
            f"{t:.1f}" for t in r["ms"][k]) + "]"
            for k, v in r["median_ms"].items()) + f"; card {power}")
    log(f"data parallel (a) collectives of one profiled step: plain "
        + fmt_collectives(coll["plain"]) + "; data parallel "
        + fmt_collectives(coll["data parallel"])
        + f" (sync-BN's {norms} batch norms: {2 * norms} all-reduces, one "
        "forward and one backward each; the criterion's mean GT count and "
        "the loss's mean one each; DDP's gradient buckets and buffer "
        f"broadcast the rest) -> {'ok' if ok else 'FAIL'}")
    return ok, r


def rank_step(r, i: int = 0):
    """A rank's (loss, {name: (gradient, parameter)}) after its steps."""
    return (r["steps"][i][0],
            {n: (g, r["params"][n]) for n, g in r["grads"].items()})


def ranks_equal(ranks, keys=("grads", "params", "buffers")):
    """The names whose tensors are not bit-equal across the ranks."""
    first = ranks[0]
    return [f"{k}:{n}" for r in ranks[1:] for k in keys
            for n, v in first[k].items() if not torch.equal(v, r[k][n])]


def dp_two_ranks_small(tmp):
    """(b) Two ranks on the one card over gloo (NCCL refuses two ranks on
    one device), the small config, a scene each: rank 0's loss, every
    gradient and the updated parameters against the same 2-rank step on
    the CPU, at the card-against-CPU tolerances; both ranks bit-equal."""
    from vdetr_tpu_torch.tools import run_ranks
    from vdetr_tpu_torch.tools.dp_step import train_rank

    cfg = small_train_config()
    batch = train_batch(cfg, 2, first=3)
    before = {n: p.detach().clone() for n, p in published_model(
        cfg, "cpu", "keyed").named_parameters()}
    card = run_ranks(train_rank, 2, dp_spec(
        tmp, "b_card", 2, "gloo", "cuda:0", cfg, [batch]), DP_GROUP_S)
    cpu = run_ranks(train_rank, 2, dp_spec(
        tmp, "b_cpu", 2, "gloo", "cpu", cfg, [batch], threads=4),
        DP_GROUP_S)
    err = train_errors(rank_step(cpu[0]), rank_step(card[0]), before)
    differ = ranks_equal(card)
    ok = all(err[k] <= TRAIN_TOL[k] for k in TRAIN_TOL) and not differ
    log("data parallel (b) two ranks on the card over gloo, small config, "
        "against the same two ranks on the CPU (plain path): "
        + fmt_train_errors(err, cpu[0]["steps"][0][0],
                           card[0]["steps"][0][0])
        + f"; the card's ranks differ in {len(differ)} tensors "
        f"{differ[:5]} -> {'ok' if ok else 'FAIL'}")
    log(TRAIN_TOL_REASON)
    return ok, err


def dp_two_ranks_published(cfg, tmp, power, single_launches):
    """(c) Two ranks on the card over gloo at the published width
    (keyed, dropout on, the auction), a scene each, two steps: finite
    losses, both ranks' parameters and buffers bit-equal after them, each
    rank's launches per step as the single-card step's (phase 5), ms per
    step and peak memory per rank; then a profiled step's collectives."""
    from vdetr_tpu_torch.tools import run_ranks
    from vdetr_tpu_torch.tools.dp_step import train_rank

    batches = [train_batch(cfg, 2, first=2 * i) for i in range(2)]
    ranks = run_ranks(train_rank, 2, dp_spec(
        tmp, "c", 2, "gloo", "cuda:0", cfg, batches, profile=True),
        DP_GROUP_S)
    differ = ranks_equal(ranks, ("params", "buffers"))
    finite = all(math.isfinite(s[0]) for r in ranks for s in r["steps"])
    launches_ok = all(s[3] == single_launches for r in ranks
                      for s in r["steps"])
    ok = finite and not differ and launches_ok
    for rank, r in enumerate(ranks):
        log(f"data parallel (c) rank {rank} of 2 over gloo on one card, "
            "published model, keyed, B=1 a rank, auction, dropout on: "
            "losses (the ranks' mean) "
            + ", ".join(f"{s[0]:.4f}" for s in r["steps"]) + "; ms a step "
            + ", ".join(f"{s[2]:.1f}" for s in r["steps"]) + "; peak "
            + ", ".join(f"{s[4]:.2f}" for s in r["steps"])
            + " GiB; launches " + "; ".join(fmt_counts(s[3], {
                k: e for k, e in single_launches.items() if e or s[3][k]})
                for s in r["steps"])
            + "; profiled step: " + fmt_collectives(r["collectives"]))
    log(f"data parallel (c) both ranks' parameters and buffers after two "
        f"steps: {len(differ)} differ {differ[:5]}; losses "
        f"{'finite' if finite else 'NOT finite'}; launches "
        f"{'as' if launches_ok else 'NOT as'} the single-card step's; card "
        f"{power} -> {'ok' if ok else 'FAIL'}")
    return ok, ranks


def run_data_parallel(cfg, power, single_launches):
    """Phase 9: (a), (b) and (c), each group of ranks spawned under a time
    limit (a rank that raises, dies or hangs fails the phase)."""
    import tempfile

    parts = {
        "world1_nccl": lambda tmp: dp_world1(cfg, tmp, power),
        "two_ranks_small_vs_cpu": dp_two_ranks_small,
        "two_ranks_published": lambda tmp: dp_two_ranks_published(
            cfg, tmp, power, single_launches)}
    ok, out = True, {"card": power}
    for name, part in parts.items():
        with tempfile.TemporaryDirectory(prefix="vdetr_dp_") as tmp:
            try:
                part_ok, res = part(tmp)
            except Exception:  # a rank raised, died or timed out
                import traceback

                log(f"data parallel {name}: FAIL\n"
                    + traceback.format_exc())
                ok = False
                continue
        ok &= part_ok
        if name == "world1_nccl":
            res = {k: res[k] for k in ("state_differs", "median_ms", "ms",
                                       "collectives")}
        elif name == "two_ranks_published":
            res = [{"steps_ms": [s[2] for s in r["steps"]],
                    "peak_gib": [s[4] for s in r["steps"]],
                    "losses": [s[0] for s in r["steps"]],
                    "collectives": r["collectives"]} for r in res]
        out[name] = res
    return ok, out


# --------------------------------------------------------------------------
# phase 11: key sharding, the large-scene stress config (the seq axis)
# --------------------------------------------------------------------------

SEQ_POINTS = 200000  # a scene; 100k a shard, the published per-rank size
# the sharded form's shape: the published decoder's queries against two
# shards of the published key count
SEQ_SHARD_KEYS = 4096


def seq_config(cfg):
    """The large-scene stress config: `cfg`'s widths, the points of a
    scene sharded over two seq ranks of one data rank."""
    return cfg.replace(mesh_axis_names=("data", "seq"), mesh_shape=(1, 2),
                       num_points=SEQ_POINTS)


def check_sharded_rpe(cfg, device, gen):
    """(a) Kernel C on each of two key shards of 4096 keys (the global
    key index through `key_offset`) merged by their log-sum-exps
    (`shard_merge`, the shards stacked in this process), and kernel F on
    each shard from the global out and lse (`shard_backward`), against
    the plain dense version over all 8192 keys, at dropout 0 and 0.1
    under one seed: the out, dq, dk, dv and dTables. Returns the C and F
    entries of the kernels line."""
    from vdetr_tpu_torch.ops.rpe_attention import (
        rpe_cross_attention, rpe_cross_attention_bwd_plain,
        rpe_cross_attention_plain, shard_backward, shard_merge)

    S = 2
    case = rpe_case(cfg.replace(preenc_npoints=S * SEQ_SHARD_KEYS), device,
                    gen)
    q, k, v, corners, angles, key_xyz, tables, key_valid = case
    key_valid[:, :SEQ_SHARD_KEYS // 2] = False  # a partly masked shard
    n = tables.shape[1]
    dout = torch.randn(q.shape, generator=gen, device=device)
    shards = [slice(s * SEQ_SHARD_KEYS, (s + 1) * SEQ_SHARD_KEYS)
              for s in range(S)]
    stack_sum = lambda x: x.sum(0, keepdim=True)  # noqa: E731
    stack_max = lambda x: x.amax(0, keepdim=True)  # noqa: E731
    ok_all, errs, res = True, [], {}
    for rate in (0.0, 0.1):
        seed = torch.tensor([777], dtype=torch.int64, device=device)
        kw = dict(log_scale=cfg.log_scale, max_value=cfg.rpe_max_value,
                  rotate=False, dropout_rate=rate)

        def forward():
            parts = [rpe_cross_attention(
                q, k[:, sl].contiguous(), v[:, sl].contiguous(), corners,
                angles, key_xyz[:, sl].contiguous(), tables,
                key_valid[:, sl].contiguous(), seed=seed,
                return_stats=True, key_offset=sl.start, **kw)
                for sl in shards]
            merged, lse, scale = shard_merge(
                torch.stack([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]),
                torch.stack([key_valid[:, sl] for sl in shards]),
                SEQ_SHARD_KEYS, stack_sum, stack_max)
            return merged[0], lse[0], scale, [p[2] for p in parts]

        def backward(out, lse, scale, logits):
            return [shard_backward(
                q, k[:, sl].contiguous(), v[:, sl].contiguous(), corners,
                angles, key_xyz[:, sl].contiguous(),
                key_valid[:, sl].contiguous(), out, lse, logits[s],
                scale[s], dout, n, seed, dict(kw, key_offset=sl.start))
                for s, sl in enumerate(shards)]

        out, lse, scale, logits = forward()
        grads = backward(out, lse, scale, logits)
        got = dict(out=out, dq=grads[0][0] + grads[1][0],
                   dk=torch.cat([g[1] for g in grads], 1),
                   dv=torch.cat([g[2] for g in grads], 1),
                   dtables=grads[0][3] + grads[1][3])
        r_out, r_lse, r_logits = rpe_cross_attention_plain(
            *case, seed=seed, return_stats=True, **kw)
        dq, dtab, ds, eg = rpe_cross_attention_bwd_plain(
            k, v, corners, angles, key_xyz, key_valid, r_out, dout, r_logits,
            r_lse, n, seed=seed, **kw)
        ref = dict(out=r_out, dq=dq, dk=torch.einsum("bhqk,bqhd->bkd", ds, q),
                   dv=torch.einsum("bhqk,bqhd->bkd", eg, dout), dtables=dtab)
        torch.cuda.synchronize()
        parts = []
        for name, want in ref.items():
            scale_ref = float(want.abs().max())
            err = float((got[name] - want).abs().max())
            tol = 1e-4 * max(1.0, scale_ref)
            ok_all &= err <= tol
            errs.append(err)
            parts.append(f"{name} {err:.3e} (tol {tol:.1e})")
        t_fwd = time_ms(forward, reps=5)
        t_bwd = time_ms(lambda: backward(out, lse, scale, logits), reps=5)
        t_pf = time_ms(lambda: rpe_cross_attention_plain(
            *case, seed=seed, return_stats=True, **kw), reps=2)
        t_pb = time_ms(lambda: rpe_cross_attention_bwd_plain(
            k, v, corners, angles, key_xyz, key_valid, r_out, dout, r_logits,
            r_lse, n, seed=seed, **kw), reps=2)
        log(f"phase 11 (a) sharded C + merge and F per shard, B=1 nQ="
            f"{q.shape[1]} 2 x {SEQ_SHARD_KEYS} keys (shard 0 half masked) "
            f"against the plain dense version over {S * SEQ_SHARD_KEYS} keys, "
            f"dropout {rate} (one seed, the global key index hashed): "
            + ", ".join(parts) + f" -> {'ok' if ok_all else 'FAIL'}; forward "
            f"(2 C launches and the merge) {t_fwd:.3f} ms, plain {t_pf:.3f}; "
            f"backward (2 F calls) {t_bwd:.3f} ms, plain {t_pb:.3f}")
        res[rate] = (t_fwd, t_bwd, t_pf, t_pb)
    log("  tolerance reason: the dense checks' (C 1e-4; F 1e-4 of the "
        "largest entry): the merge adds two shards' partial sums in "
        "another order, ~1e-6 relative")
    fb, fby = rpe_bound(case, train=True)
    bb, bby = rpe_bound(case, train=True, backward=True,
                        tensor_core_products=True)
    t_fwd, t_bwd, t_pf, t_pb = res[0.1]
    c = dict(ok=ok_all, err=max(errs), ms=t_fwd, plain_ms=t_pf, bound_ms=fb,
             bound_by=fby, ms_dropout0=res[0.0][0],
             shape=f"B=1 nQ={q.shape[1]} 2 x {SEQ_SHARD_KEYS} keys")
    f = dict(ok=ok_all, err=max(errs), ms=t_bwd, plain_ms=t_pb, bound_ms=bb,
             bound_by=bby, ms_dropout0=res[0.0][1], shape=c["shape"])
    return c, f


def seq_spec(tmp, name, device, cfg, batches, **kw):
    return dp_spec(tmp, name, 2, "gloo", device, cfg, batches, **kw)


def seq_small_vs_cpu(tmp):
    """(b) A small seq step (mesh (1, 2), two ranks on the card over
    gloo) against the same two ranks on the CPU (plain versions): the
    loss, every gradient and the updated parameters, at the small train
    step's tolerances; both ranks bit-equal."""
    from vdetr_tpu_torch.tools import run_ranks
    from vdetr_tpu_torch.tools.dp_step import train_rank

    cfg = small_train_config().replace(mesh_axis_names=("data", "seq"),
                                       mesh_shape=(1, 2))
    batch = train_batch(cfg, 1, first=3)
    before = {n: p.detach().clone() for n, p in published_model(
        cfg.replace(mesh_axis_names=("data",), mesh_shape=(-1,)), "cpu",
        "keyed").named_parameters()}
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:  # the two groups side by side
        card_f = pool.submit(run_ranks, train_rank, 2, seq_spec(
            tmp, "s_card", "cuda:0", cfg, [batch]), DP_GROUP_S)
        cpu = run_ranks(train_rank, 2, seq_spec(
            tmp, "s_cpu", "cpu", cfg, [batch], threads=3), DP_GROUP_S)
        card_r = card_f.result()
    err = train_errors(rank_step(cpu[0]), rank_step(card_r[0]), before)
    differ = ranks_equal(card_r)
    ok = all(err[k] <= TRAIN_TOL[k] for k in TRAIN_TOL) and not differ
    log("phase 11 (b) seq step, mesh (1, 2), two ranks on the card over "
        "gloo, small config, against the same two ranks on the CPU (plain "
        "path): " + fmt_train_errors(err, cpu[0]["steps"][0][0],
                                     card_r[0]["steps"][0][0])
        + f"; the card's ranks differ in {len(differ)} tensors "
        f"{differ[:5]} -> {'ok' if ok else 'FAIL'}")
    log(TRAIN_TOL_REASON)
    return ok, err


def check_pointnet2(device):
    """(c) The pointnet2 set-abstraction (FPS on kernel B) and
    feature-propagation modules on the card against the CPU, in train
    mode, same weights and inputs."""
    import copy

    from vdetr_tpu_torch.models.pointnet2 import (PointnetFPModule,
                                                  PointnetSAModuleVotes)

    g = torch.Generator().manual_seed(SEED)
    xyz = torch.rand(2, 4096, 3, generator=g) * 4
    feats = torch.randn(2, 4096, 16, generator=g)
    sa = PointnetSAModuleVotes(512, 0.4, 32, [32, 64], in_channels=16)
    fp = PointnetFPModule([64, 32], in_channels=64 + 16)
    errs = {}
    with torch.no_grad():
        outs = {}
        for dev in ("cpu", device):
            a, b = copy.deepcopy(sa).to(dev), copy.deepcopy(fp).to(dev)
            new_xyz, pooled, inds = a(xyz.to(dev), feats.to(dev))
            prop = b(xyz.to(dev), new_xyz, feats.to(dev), pooled)
            outs[str(dev)] = [t.cpu() for t in (inds, pooled, prop)]
        c, k = outs["cpu"], outs[str(device)]
    errs["inds_equal"] = bool(torch.equal(c[0].long(), k[0].long()))
    errs["pooled"] = float((c[1] - k[1]).abs().max())
    errs["propagated"] = float((c[2] - k[2]).abs().max())
    ok = (errs["inds_equal"] and errs["pooled"] <= 1e-4
          and errs["propagated"] <= 1e-4)
    log(f"phase 11 (c) pointnet2 SA (4096 points -> 512 centers by kernel B, "
        f"ball query 32) and FP modules, train mode, card against CPU: "
        f"centers {'equal' if errs['inds_equal'] else 'DIFFER'}, pooled "
        f"{errs['pooled']:.3e}, propagated {errs['propagated']:.3e} (tol "
        f"1e-4: f32 sums in another order) -> {'ok' if ok else 'FAIL'}")
    return ok, errs


# the kernels a seq eval step and a seq train step must launch (keyed)
SEQ_EVAL_KERNELS = ("keyed_conv", "fps", "rpe_cross_attention", "nms")
SEQ_TRAIN_KERNELS = ("keyed_conv", "keyed_conv_dw", "fps",
                     "rpe_cross_attention", "rpe_cross_attention_bwd",
                     "rpe_table_sum", "auction")


def seq_published(cfg, tmp, power):
    """The large-scene stress config on the card: mesh (1, 2), two ranks
    sharing the card over gloo (NCCL refuses two ranks on one device),
    200000 points a scene, `VDETRConfig()` widths, keyed: one eval step
    (test_only) at B = 1, then two train steps (dropout on, the auction),
    then the same two steps again from the same weights: finite outputs
    and losses, the two runs bit-equal, both ranks' parameters equal,
    every kernel of the path launched (counts zeroed before each step and
    read after it, on each rank), ms a step and peak memory a rank."""
    from vdetr_tpu_torch.tools import run_ranks
    from vdetr_tpu_torch.tools.dp_step import train_rank

    scfg = seq_config(cfg)
    batches = [train_batch(scfg, 1, first=i) for i in range(2)]
    t0 = time.perf_counter()
    ranks = run_ranks(train_rank, 2, seq_spec(
        tmp, "seq", "cuda:0", scfg, batches, eval_cfg=eval_config(scfg),
        eval_batches=batches[:1], repeat=True), DP_GROUP_S)
    wall = time.perf_counter() - t0
    differ = ranks_equal(ranks, ("params", "buffers"))
    finite = all(math.isfinite(s[0]) for r in ranks for s in r["steps"]) \
        and all(e[0] for r in ranks for e in r["eval"])
    missing = sorted({k for r in ranks for s in r["steps"]
                      for k in SEQ_TRAIN_KERNELS if not s[3][k]}
                     | {k for r in ranks for e in r["eval"]
                        for k in SEQ_EVAL_KERNELS if not e[2][k]})
    repeat = sorted({n for r in ranks for n in r["repeat_differs"]})
    ok = finite and not differ and not missing and not repeat
    for rank, r in enumerate(ranks):
        e = r["eval"][0]
        log(f"phase 11 seq rank {rank} of mesh (1, 2) on one card over gloo, "
            f"{SEQ_POINTS} points a scene ({SEQ_POINTS // 2} a rank), "
            f"published widths, keyed: eval step {e[1]:.1f} ms, peak "
            f"{e[3]:.2f} GiB, {e[4]} boxes kept, launches "
            + ", ".join(f"{k} {e[2][k]}" for k in SEQ_EVAL_KERNELS)
            + "; train steps (dropout on, auction) losses "
            + ", ".join(f"{s[0]:.4f}" for s in r["steps"]) + "; ms "
            + ", ".join(f"{s[2]:.1f}" for s in r["steps"]) + "; peak "
            + ", ".join(f"{s[4]:.2f}" for s in r["steps"]) + " GiB; launches "
            + "; ".join(", ".join(f"{k} {s[3][k]}" for k in SEQ_TRAIN_KERNELS)
                        for s in r["steps"]))
    log(f"phase 11 seq: both ranks' parameters and buffers after two steps: "
        f"{len(differ)} differ {differ[:5]}; the same two steps again from "
        f"the same weights: {len(repeat)} differ {repeat[:5]}; outputs and "
        f"losses {'finite' if finite else 'NOT finite'}; kernels never "
        f"launched: {missing}; wall {wall:.1f} s (spawn and build included); "
        f"card {power} -> {'ok' if ok else 'FAIL'}")
    return ok, ranks


def run_seq(cfg, device, power):
    """Phase 11: (a) the sharded C and F against the dense plain version,
    (b) a small seq step on the card against the CPU, (c) the pointnet2
    modules, and the large-scene stress config's eval and train steps,
    each group of ranks spawned under a time limit."""
    import tempfile

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    ok, out = True, {"card": power}
    try:
        c, f = check_sharded_rpe(cfg, device, gen)
    except Exception:
        import traceback

        log("phase 11 (a): FAIL\n" + traceback.format_exc())
        return False, out, None
    out["sharded"] = {"rpe_cross_attention_sharded": c,
                      "rpe_cross_attention_bwd_sharded": f}
    ok &= c["ok"]
    ok_p, out["pointnet2"] = check_pointnet2(device)
    ok &= ok_p
    torch.cuda.empty_cache()
    ranks = None
    for name, part in (("small_vs_cpu", seq_small_vs_cpu),
                       ("published", lambda t: seq_published(cfg, t,
                                                             power))):
        with tempfile.TemporaryDirectory(prefix="vdetr_seq_") as tmp:
            try:
                part_ok, res = part(tmp)
            except Exception:  # a rank raised, died or timed out
                import traceback

                log(f"phase 11 {name}: FAIL\n" + traceback.format_exc())
                ok = False
                continue
        ok &= part_ok
        if name == "published":
            ranks = res
            res = [{"eval_ms": r["eval"][0][1], "eval_peak_gib":
                    r["eval"][0][3], "steps_ms": [s[2] for s in r["steps"]],
                    "peak_gib": [s[4] for s in r["steps"]],
                    "losses": [s[0] for s in r["steps"]],
                    "train_launches": r["steps"][0][3],
                    "eval_launches": r["eval"][0][2]} for r in res]
        out[name] = res
    return ok, out, ranks


# --------------------------------------------------------------------------
# phase 10: the JAX model's other configurations: bf16 (the bf16 forms of
# A, H, D and I), the Bottleneck backbone, the decoder and head flags
# --------------------------------------------------------------------------

BF16_CONV_REASON = (
    "bf16 products are exact in f32: the kernel and its plain version "
    "(the f32 gather-and-matmul of the bf16 values) differ in the order "
    "of their f32 sums and in the kernel's 64-wide stages, each a chain of "
    "four wgmma k16 steps truncated to f32 and added to the running sum "
    "in f32; emulated, ~6e-7 of max|ref| at K = 27*512, a hundredth of "
    "the f32 form's tolerance (tests/test_torch_kernel_premises.py)")
BF16_DW_REASON = (
    "each dout is split into two bf16 halves (~2^-17 of it against a bf16 "
    "feature, ~2.7e-6 of max|ref| at the published shapes), then 64-hit "
    "stages of truncating wgmma k16 chains (the low half's, then the "
    "high's) added in f32 over up to 65536 rows, in another order than "
    "the plain GEMM's; emulated within a tenth of the f32 form's 2e-5 of "
    "max|ref| (tests/test_torch_kernel_premises.py)")
BF16_BOUND_NOTE = ("bound_ms: bf16 on the tensor cores (flops, x 2 for the "
                   "weight gradient's two halves, / 989 TFLOP/s against "
                   "bytes, features and weights at 2 bytes, / 3.35 TB/s); "
                   "bound_f32_ms: flops / 67 TFLOP/s on the CUDA cores")
# the decoder and head flags of the JAX model (random_fps permutes the
# voxels from the step's generator in training)
FLAGS = dict(pos_for_key=True, share_selfattn=True, querypos_mlp=False,
             mlp_norm="ln", mlp_act="gelu", random_fps=True)


def bf16_cases(cases):
    """The conv cases with bf16 features and weights (dout stays f32, the
    cotangent of the JAX package's bf16 backward)."""
    out = []
    for label, args, dout, hits, nbr in cases:
        args = (args[0].bfloat16(),) + args[1:5] + (args[5].bfloat16(),)
        out.append((label, args, dout, hits, nbr))
    return out


def check_bf16_forms(cases, f32_res):
    """The bf16 forms of A, D, H and I against their plain versions at the
    published shapes, each case's ms beside the f32 form's of this call
    (`f32_res`); H bit for bit against A's bf16 form, I against D's, each
    of the four against a second call of itself."""
    from vdetr_tpu_torch.ops.sparse_conv_keyed import (keyed_conv_bf16,
                                                       keyed_conv_dw_bf16,
                                                       keyed_conv_dw_plain,
                                                       keyed_conv_plain)
    from vdetr_tpu_torch.ops.sparse_conv_kernel import (mapped_conv_bf16,
                                                        mapped_conv_dw_bf16,
                                                        mapped_conv_dw_plain,
                                                        mapped_conv_plain)

    bcases = bf16_cases(cases)
    dw_bound = lambda io, flops: bound_bf16_ms(io, flops, 2)  # noqa: E731
    res = {
        "keyed_conv_bf16": check_conv_kernel(
            "keyed_conv_bf16", bcases, keyed_conv_bf16, keyed_conv_plain,
            1e-4, BF16_CONV_REASON, lambda c: c[1], conv_tile_rows,
            bound_bf16_ms, BF16_BOUND_NOTE),
        "keyed_conv_dw_bf16": check_conv_kernel(
            "keyed_conv_dw_bf16", bcases, keyed_conv_dw_bf16,
            keyed_conv_dw_plain, 2e-5, BF16_DW_REASON,
            lambda c: c[1][:5] + (c[2],), dw_rows, dw_bound,
            BF16_BOUND_NOTE),
        "mapped_conv_bf16": check_conv_kernel(
            "mapped_conv_bf16", bcases, mapped_conv_bf16, mapped_conv_plain,
            1e-4, BF16_CONV_REASON, lambda c: (c[1][0], c[4], c[1][5]),
            conv_tile_rows, bound_bf16_ms, BF16_BOUND_NOTE),
        "mapped_conv_dw_bf16": check_conv_kernel(
            "mapped_conv_dw_bf16", bcases, mapped_conv_dw_bf16,
            mapped_conv_dw_plain, 2e-5, BF16_DW_REASON,
            lambda c: (c[1][0], c[4], c[2]), dw_rows, dw_bound,
            BF16_BOUND_NOTE)}
    for i, (label, args, dout, _, nbr) in enumerate(bcases):
        a = keyed_conv_bf16(*args)
        h = mapped_conv_bf16(args[0], nbr, args[5])
        d = keyed_conv_dw_bf16(*args[:5], dout)
        i_ = mapped_conv_dw_bf16(args[0], nbr, dout)
        same = {"H vs A": torch.equal(h, a),
                "I vs D": torch.equal(i_, d),
                "A twice": torch.equal(keyed_conv_bf16(*args), a),
                "H twice": torch.equal(mapped_conv_bf16(args[0], nbr,
                                                        args[5]), h),
                "D twice": torch.equal(keyed_conv_dw_bf16(*args[:5], dout),
                                       d),
                "I twice": torch.equal(mapped_conv_dw_bf16(args[0], nbr,
                                                           dout), i_)}
        res["keyed_conv_bf16"]["ok"] &= same["A twice"]
        res["mapped_conv_bf16"]["ok"] &= same["H vs A"] and same["H twice"]
        res["keyed_conv_dw_bf16"]["ok"] &= same["D twice"]
        res["mapped_conv_dw_bf16"]["ok"] &= same["I vs D"] and same["I twice"]
        log(f"check bf16 forms {label}: bit-equal "
            + ", ".join(f"{k} {v}" for k, v in same.items())
            + f" -> {'ok' if all(same.values()) else 'FAIL'}")
    for name, r in res.items():
        f32 = f32_res[name[:-len("_bf16")]]
        r["f32_ms"] = f32["ms"]
        for rec, frec in zip(r["cases"], f32["cases"]):
            rec["f32_ms"] = frec["ms"]
        log(f"check {name}: bf16 form {r['ms']:.4f} ms over the four "
            f"published cases against the f32 form's {f32['ms']:.4f} ms "
            "in this call ("
            + "; ".join(f"{c['ms']:.4f} vs {c['f32_ms']:.4f}"
                        for c in r["cases"]) + ")")
    return res


def bf16_step_ms(train, kname):
    """Device ms of a bf16 form's launches in phase 10's profiled bf16
    train step of its route (`profile_step`): A and H by their own kernel
    names, with their split sums; D and I as the step's weight gradients
    (every one of them is the bf16 form there)."""
    by_kernel = train["profile"]["by_kernel"]
    key = kname[:-len("_bf16")] if "_dw" in kname else kname
    return by_kernel.get(key, {}).get("ms")


def align_queries(ref, got):
    """`got`'s final outputs reordered to `ref`'s queries, each matched to
    the query whose proposal center is nearest (well-posed configs take
    every seed as a proposal, in an order bf16 may change); None when a
    query has no match within 1e-2 m."""
    order = []
    for r, g in zip(ref["pre_box_center_unnormalized"],
                    got["pre_box_center_unnormalized"]):
        d = (r[:, None, :] - g[None, :, :]).abs().amax(-1)
        if float(d.amin(1).max()) > 1e-2:
            return None
        order.append(d.argmin(1))
    order = torch.stack(order)
    return {k: v.gather(1, order.reshape(order.shape + (1,) * (v.ndim - 2))
                        .expand((-1, -1) + v.shape[2:]))
            for k, v in got.items()}


def well_posed(cfg):
    """`cfg` with outputs continuous in the backbone's features, for
    comparing bf16 computations: every seed a proposal with its own
    features as the query, unit anchors (the published top-k cut, slot
    order and anchor-class argmax are near-ties at random weights, which
    one bf16 ulp flips: tests/test_torch_bf16.py)."""
    return cfg.replace(nqueries=cfg.preenc_npoints, q_content="sample",
                       hard_anchor=True)


@contextlib.contextmanager
def conv_calls_against_cpu(record):
    """Every call of the sparse convs' autograd Functions (`_KeyedConv`,
    `_MappedConv`) on the card, forward and backward, recomputed on the
    CPU's plain path from the same inputs; appends (kind, feats shape,
    weights shape, dtype, max err / max of each output) to `record`."""
    from vdetr_tpu_torch.ops import sparse_conv_keyed, sparse_conv_kernel

    def rel(got, ref):
        if got is None:
            return 0.0
        ref = ref.float()
        return float((got.cpu().float() - ref).abs().max()
                     / ref.abs().max().clamp(min=1e-30))

    class Ctx:  # a Function's context on the CPU: what it saves and reads
        def __init__(self, ctx=None):
            if ctx is not None:
                self.saved_tensors = tuple(t.cpu() for t in ctx.saved_tensors)
                for k in ("extent", "submanifold", "needs_input_grad"):
                    if hasattr(ctx, k):
                        setattr(self, k, getattr(ctx, k))

        def save_for_backward(self, *tensors):
            self.saved_tensors = tensors

    patched = []
    for fn in (sparse_conv_keyed._KeyedConv, sparse_conv_kernel._MappedConv):
        fwd, bwd = fn.forward, fn.backward

        def forward(ctx, feats, weights, *rest, fwd=fwd, name=fn.__name__):
            out = fwd(ctx, feats, weights, *rest)
            if feats.is_cuda:
                ref = fwd(Ctx(), feats.cpu(), weights.cpu(),
                          *(r.cpu() if torch.is_tensor(r) else r
                            for r in rest))
                record.append((name + " forward", tuple(feats.shape),
                               tuple(weights.shape), str(feats.dtype),
                               [rel(out, ref)]))
            return out

        def backward(ctx, dout, bwd=bwd, name=fn.__name__):
            out = bwd(ctx, dout)
            if dout.is_cuda:
                ref = bwd(Ctx(ctx), dout.cpu())
                feats, weights = ctx.saved_tensors[:2]
                record.append((name + " backward", tuple(feats.shape),
                               tuple(weights.shape), str(feats.dtype),
                               [rel(g, r) for g, r in zip(out[:2], ref[:2])
                                if r is not None]))
            return out

        patched.append((fn, fn.forward, fn.backward))
        fn.forward, fn.backward = staticmethod(forward), staticmethod(backward)
    try:
        yield record
    finally:
        for fn, fwd, bwd in patched:
            fn.forward, fn.backward = staticmethod(fwd), staticmethod(bwd)


# the conv calls of a step on the card against the CPU: f32 sums in other
# orders (f32 forms: the conv tolerance, 1e-4 of max); under bf16 each
# dFeats and dW is rounded to bf16 once, which another order of the f32
# sum below it can move by one ulp (2^-8 of a value)
CONV_CALL_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2 ** -7}


def check_small_step_calls_against_cpu(device, route, base, label):
    """A small model's train step (dropout 0) on the card: its loss against
    the same step's on the CPU, and every sparse conv call of it, forward
    and backward, against the CPU's plain path on the same inputs. The
    whole step's gradients are not compared: at these configs the step
    sits on a kink (on the CPU, weights moved by 3e-7 of themselves move
    the depth-50 gradients by 0.4%, the bf16 ones by 15%, its loss not at
    all), so the card's f32 sums in another order pick other one-sided
    derivatives; the calls are where the kernels act."""
    import copy

    from vdetr_tpu_torch.models.vdetr import build_model
    from vdetr_tpu_torch.train.engine import Trainer

    cfg = small_train_config(base)
    ds = dataset_of(cfg)
    cpu = build_model(cfg, ds, generator=torch.Generator().manual_seed(SEED),
                      device="cpu", conv_route=route)
    card = copy.deepcopy(cpu).to(device)
    batch = train_batch(cfg, 2, first=3)
    losses, calls = {}, []
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, device)):
        tr = Trainer(cfg, model, ds, steps_per_epoch=1, device=dev)
        with conv_calls_against_cpu(calls):
            losses[name], _ = tr.train_step(batch, torch.Generator(device=dev))
    loss_err = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    loss_tol = 1e-3 if cfg.compute_dtype == "bfloat16" else 1e-4
    worst = max(calls, default=None,
                key=lambda c: max(c[4]) / CONV_CALL_TOL[c[3]])
    bad = [c for c in calls if max(c[4]) > CONV_CALL_TOL[c[3]]]
    ok = loss_err <= loss_tol and not bad and worst is not None
    log(f"train {route} step small {label} config on card vs CPU: loss "
        f"{losses['card']:.6f} vs {losses['cpu']:.6f} (rel err "
        f"{loss_err:.2e}, tol {loss_tol:.0e}); {len(calls)} sparse conv "
        f"calls each against the CPU on the same inputs, worst {worst}, "
        f"{len(bad)} over the tolerance {CONV_CALL_TOL} -> "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def check_small_bf16_forward_against_cpu(device, route):
    """A small bf16 model (`well_posed`) on `route`: the eval forward on
    the card against the CPU's plain path, query by query: the logits'
    cosine > 0.9999 and the median center deviation < 0.02 m (the JAX
    package's own bf16 bounds are 0.999 and 0.02, bf16 against f32).
    Element by element the two differ by whole bf16 ulps wherever the
    card's sums round a stored feature the other way."""
    import copy

    from vdetr_tpu_torch.models.vdetr import build_model

    cfg = well_posed(small_train_config(
        tiny_config().replace(compute_dtype="bfloat16")))
    cpu = build_model(cfg, dataset_of(cfg),
                      generator=torch.Generator().manual_seed(SEED),
                      device="cpu", conv_route=route)
    card = copy.deepcopy(cpu).to(device)
    inputs = synthetic_batch(cfg.num_points, 2, "cpu")
    with torch.inference_mode():
        ref = cpu(inputs)["outputs"]
        got = card({k: v.to(device) for k, v in inputs.items()})["outputs"]
        got = align_queries(ref, {k: v.cpu() for k, v in got.items()})
    if got is None:
        log(f"forward {route} small bf16 config on card vs CPU: a query "
            "without a match -> FAIL")
        return False
    a, b = ref["sem_cls_logits"].double(), got["sem_cls_logits"].double()
    cos = float((a * b).sum() / (a.norm() * b.norm()))
    dev = float((ref["center_unnormalized"] - got["center_unnormalized"]
                 ).abs().median())
    ok = cos > 0.9999 and dev < 0.02
    log(f"forward {route} small bf16 config on card vs CPU plain path "
        f"(queries matched by proposal center): logits cosine {cos:.7f} "
        f"(> 0.9999), median center deviation {dev:.2e} m (< 0.02) -> "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def run_bf16(cfg32, device, power, f32_train_launches, f32_train):
    """Phase 10 (a): the published model with the bf16 backbone
    (compute_dtype="bfloat16"): the eval step on both routes at B = 1 and
    4 and the train step on both routes at B = 1 under the auction (run_eval
    and run_train: launches per form, bit-equal parameters after two whole
    steps); A/D (keyed) and H/I (mapped) launches of a step in all equal to
    the f32 step's (`f32_train_launches`), peak memory beside the f32
    step's."""
    cfg = cfg32.replace(compute_dtype="bfloat16")
    models = {route: published_model(cfg, device, route) for route in ROUTES}
    ok_e, eval_launches, eval_per, _, trainers = run_eval(
        models, eval_config(cfg), device, power, reps=3)
    del models, trainers
    torch.cuda.empty_cache()
    ok_t, train_launches, train = run_train(
        cfg, device, power, variants={"keyed": ("keyed", "auction"),
                                      "mapped": ("mapped", "auction")},
        detail=())
    ok_l = True
    for route, conv in (("keyed", "keyed_conv"), ("mapped", "mapped_conv")):
        b, f = train_launches[route], f32_train_launches[route]
        got = (b[conv] + b[conv + "_bf16"], b[conv + "_dw_bf16"])
        want = (f[conv], f[conv + "_dw"])
        same = got == want and b[conv + "_dw"] == 0
        ok_l &= same
        log(f"train bf16 {route}: {conv} launches {b[conv]} f32 form "
            f"(dFeats) + {b[conv + '_bf16']} bf16 form = {got[0]}, "
            f"{conv}_dw_bf16 {got[1]}; the f32 step's {want[0]} and "
            f"{want[1]} -> {'ok' if same else 'FAIL'}; peak memory "
            f"{train[route]['peak_gib']:.2f} GiB against the f32 step's "
            f"{f32_train[route]['peak_gib']:.2f} GiB; median "
            f"{train[route]['ms_per_step']:.1f} ms against "
            f"{f32_train[route]['ms_per_step']:.1f} ms; card {power}")
    return ok_e and ok_t and ok_l, eval_launches, eval_per, \
        train_launches, train


def run_config_steps(cfg, device, power, label, steps: int = 2,
                     route: str = "keyed"):
    """Phase 10 (b) and (c): the model of `cfg` at the published width on
    `route`: one eval step (`test_only`; launches, boxes kept, ms, peak
    memory), then `steps` train steps at B = 1 under the auction (each
    step's launches, finite loss and gradients, ms, peak memory), then one
    more under torch.profiler (device busy, device ms per port kernel)."""
    from vdetr_tpu_torch.train.engine import Trainer

    ds = dataset_of(cfg)
    model = published_model(cfg, device, route)
    counters = launch_counters()
    ecfg = eval_config(cfg)
    trainer = Trainer(ecfg, model, ds, steps_per_epoch=1000, device=device)
    inputs = synthetic_batch(cfg.num_points, 1, device, ds=ds)
    expected = expected_launches(model, cfg)
    expected["nms"] = 1
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.eval_step(inputs)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    counts = {k: fn.launches for k, fn in counters.items()}
    bad = [k for k, v in out.items()
           if not bool(torch.isfinite(v.float()).all())]
    kept = int(out["nms_keep"].sum())
    ok = counts == expected and not bad and kept > 0
    rec = {"eval": {"ms": eval_ms, "kept": kept, "launches": counts,
                    "peak_gib": torch.cuda.max_memory_allocated(device)
                    / 2 ** 30}}
    log(f"{label} eval step (test_only) {route} B=1: launches "
        + fmt_counts(counts, expected)
        + f"; outputs {'finite' if not bad else bad[:5]}; {kept} boxes "
        f"kept; {eval_ms:.1f} ms (first call); peak memory "
        f"{rec['eval']['peak_gib']:.2f} GiB -> {'ok' if ok else 'FAIL'}")
    del out
    trainer = Trainer(cfg, model, ds, steps_per_epoch=1000, device=device)
    expected = expected_launches(model, cfg, train=True)
    gen = torch.Generator(device=device).manual_seed(SEED)
    rec["train"] = []
    for i in range(steps):
        batch = train_batch(cfg, 1, first=i)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        counts = {k: fn.launches for k, fn in counters.items()}
        nonfinite = grads_finite(trainer.model)
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        step_ok = (math.isfinite(loss) and not nonfinite
                   and counts == expected)
        ok &= step_ok
        rec["train"].append({"ms": dt, "loss": loss, "peak_gib": peak,
                             "launches": counts})
        log(f"{label} train step {i} {route} B=1: loss {loss:.4f}, "
            f"{dt:.1f} ms, grads "
            f"{'finite' if not nonfinite else nonfinite[:3]}, launches "
            + fmt_counts(counts, expected)
            + f", peak memory {peak:.2f} GiB -> "
            f"{'ok' if step_ok else 'FAIL'}; card {power}")
    prof = profile_step(trainer, batch, gen)
    rec["profile"] = {k: prof[k] for k in ("device_busy_ms", "wall_ms",
                                           "port_kernels_ms", "by_kernel")}
    log(f"{label} train step under torch.profiler: device busy "
        f"{prof['device_busy_ms']:.1f} ms of {prof['wall_ms']:.1f} ms host "
        f"clock, in the port's kernels {prof['port_kernels_ms']:.1f}; per "
        "port kernel (ms, launches): " + "; ".join(
            f"{k} {v['ms']:.2f} ({v['launches']})"
            for k, v in sorted(prof["by_kernel"].items())))
    del trainer, model
    torch.cuda.empty_cache()
    return ok, rec


def run_configs(cfg32, device, power, res, f32_train_launches, f32_train):
    """Phase 10: (a) bf16, (b) depth 50, (c) the decoder and head flags at
    published widths, (d) small configs of each on the card against the
    CPU. Adds the bf16 forms' kernel checks to `res`."""
    from vdetr_tpu_torch.config import VDETRConfig

    ok_a, eval_l, eval_per, train_l, train = run_bf16(
        cfg32, device, power, f32_train_launches, f32_train)
    ok_b, depth50 = run_config_steps(VDETRConfig(depth=50), device, power,
                                     "depth 50 (Bottleneck)")
    ok_c, flags = run_config_steps(VDETRConfig(**FLAGS), device, power,
                                   "decoder and head flags")
    tiny = tiny_config()
    bf16 = well_posed(tiny.replace(compute_dtype="bfloat16"))
    ok_d = []
    for route in ROUTES:
        ok_d.append(check_small_bf16_forward_against_cpu(device, route))
        ok_d.append(check_small_step_calls_against_cpu(device, route, bf16,
                                                       "bf16"))
    for base in (tiny.replace(depth=50), tiny.replace(**FLAGS)):
        ok_d.append(check_small_forward_against_cpu(
            device, torch.Generator().manual_seed(SEED + 1), "keyed", base))
        ok_d.append(check_small_eval_against_cpu(device, "keyed", base))
    ok_d.append(check_small_step_calls_against_cpu(
        device, "keyed", tiny.replace(depth=50), "depth 50"))
    # train mode draws random_fps's permutation from the step's generator,
    # which differs between the card and the CPU: the flags' train step
    # is compared without it
    ok_d.append(check_small_train_against_cpu(
        device, "keyed", tiny.replace(**{k: v for k, v in FLAGS.items()
                                         if k != "random_fps"})))
    log(f"configurations small on card vs CPU: {sum(ok_d)} of {len(ok_d)} "
        "ok")
    rec = {"bf16": {"eval_step": {route: {f"B={b}": v for b, v in
                                          eval_per[route].items()}
                                  for route in ROUTES},
                    "train": train, "eval_launches": eval_l,
                    "train_launches": train_l},
           "depth50": depth50, "flags": flags}
    return ok_a and ok_b and ok_c and all(ok_d), rec


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
    start = time.perf_counter()

    def phase(n):
        log(f"phase {n} starts at {time.perf_counter() - start:.1f} s")

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

    phase("3")
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
    res16 = check_bf16_forms(cases, res)
    del cases
    res["fps"] = check_fps(cfg, grids)
    res["rpe_cross_attention"], case = check_rpe(cfg, device, gen)
    res["rpe_cross_attention_bwd"] = check_rpe_bwd(cfg, case)
    res["rpe_table_sum"] = check_rpe_table_sum(cfg, device, gen)
    del case, grids
    res["auction"] = check_auction(cfg, device, smi)

    phase("3b")
    # 3b. the probes of kernel C
    res["rpe_ablate"] = check_rpe_ablate(device)
    res["dot_micro"] = check_dot_micro(device)

    phase("4")
    # 4. the published forward on both routes, then a small one on each
    # against the CPU
    models = {route: published_model(cfg, device, route) for route in ROUTES}
    ok_f, fwd_launches, per_scene = run_forward(models, cfg, device, smi)
    ok_fpn, fpn_err = compare_fpn(models, cfg, device)

    phase("4b")
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

    phase("5")
    # 5. the published train step on both routes under the auction, and
    # under JV on the keyed route, then a small one on each route against
    # the CPU
    ok_t, train_launches, train = run_train(
        cfg, device, smi, variants={"keyed": ("keyed", "auction"),
                                    "mapped": ("mapped", "auction"),
                                    "keyed jv": ("keyed", "jv")},
        detail=("keyed", "mapped"))
    ok_ts = all(check_small_train_against_cpu(device, route)
                for route in ROUTES)
    torch.cuda.empty_cache()

    phase("6")
    # 6. the CLI at the published width on fabricated ScanNet scans
    ok_c, cli = run_cli(device, smi)

    phase("7")
    # 7. SUN RGB-D at the published width: kernel R against its plain
    # version, the eval step and the AP (the device NMS, then the host's
    # rotated NMS), a small forward, eval and train step per route against
    # the CPU, the train step on both routes under the auction (R forward
    # and backward on every job), the diou / iou steps, and the CLI on
    # fabricated scans
    from vdetr_tpu_torch.eval.ap_calculator import config_dict_from_cfg

    scfg = sun_config()
    res["rotated_iou"] = check_rotated_iou(scfg, device, smi)
    torch.cuda.empty_cache()
    smodels = {route: published_model(scfg, device, route)
               for route in ROUTES}
    secfg = eval_config(scfg)
    ok_sev, sun_eval_launches, sun_eval, _, strainers = run_eval(
        smodels, secfg, device, smi, reps=3)
    ok_sap, sun_ap = run_ap(strainers["keyed"], secfg)
    strainers["keyed"].ap_config = config_dict_from_cfg(
        secfg.replace(rotated_nms=True), dataset_of(secfg))
    ok_sapr, sun_ap_rot = run_ap(strainers["keyed"], secfg)
    del smodels, strainers
    stiny = sun_tiny_config()
    ok_ss = [check(device, route, stiny) for route in ROUTES for check in (
        lambda d, r, b: check_small_forward_against_cpu(
            d, torch.Generator().manual_seed(SEED + 1), r, b),
        check_small_eval_against_cpu, check_small_train_against_cpu)]
    torch.cuda.empty_cache()
    ok_st, sun_train_launches, sun_train = run_train(
        scfg, device, smi, variants={"keyed": ("keyed", "auction"),
                                     "mapped": ("mapped", "auction")},
        detail=("keyed",))
    torch.cuda.empty_cache()
    ok_si, sun_iou = run_iou_types(scfg, device, smi)
    ok_sc, sun_cli = run_cli(device, smi, dataset="sunrgbd")
    torch.cuda.empty_cache()

    phase("9")
    # 9. data parallel: world 1 on NCCL against the plain step, two ranks
    # on the one card over gloo against the CPU (small) and at the
    # published width
    ok_dp, dp = run_data_parallel(cfg, smi, train_launches["keyed"])
    torch.cuda.empty_cache()

    phase("10")
    # 10. the JAX model's other configurations: bf16, depth 50, the
    # decoder and head flags, and small ones against the CPU
    ok_cfg, configs = run_configs(cfg, device, smi, res16, train_launches,
                                  train)
    torch.cuda.empty_cache()

    phase("11")
    # 11. key sharding: the sharded C and F against the dense plain
    # version, a small seq step against the CPU, the pointnet2 modules,
    # and the large-scene stress config on two ranks sharing the card
    ok_seq, seq, seq_ranks = run_seq(cfg, device, smi)
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
                    else sun_train_launches[route][kname]
                    if kname == "rotated_iou"
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
        for rt in ROUTES:
            entry["launches_by_route"][rt].update(
                sunrgbd_eval_step=sun_eval_launches[rt][kname],
                sunrgbd_train_step=sun_train_launches[rt][kname])
        for extra in ("cases", "train_ms", "gather_matmul_ms",
                      "library_tf32_ms", "bound_f32_ms", "bound_note",
                      "ms_dropout0", "pair_ms", "pair_ms_dropout0",
                      "dq_sum_ms", "pair_bound_ms", "pair_bound_by",
                      "pair_bound_f32_ms", "pair_sass", "table_ms",
                      "table_bound_ms", "table_bound_by", "table_sass",
                      "table_sum_ms", "forward_maps", "ms_note", "slices",
                      "exchange_floor_ms", "device_ms", "mask_ms",
                      "scan_ms", "mask_bytes", "fwd_ms", "bwd_ms",
                      "gated_share", "backward_max_rel_err"):
            if extra in r:
                entry[extra] = r[extra]
        if kname == "nms":
            entry["launches_note"] = ("per eval step (the main path's end); "
                                      "the forward and the train step run "
                                      "no NMS")
        if kname == "auction":
            entry["launches_note"] = ("per train step under the auction "
                                      "matcher (the default): one a shape "
                                      "group; ms, plain_ms and bound_ms sum "
                                      "the B = 1 step's launches")
        if kname == "rotated_iou":
            entry["launches_note"] = (
                "per SUN RGB-D train step under the GIoU: one forward and "
                "one backward launch a criterion job (0 in an eval step, "
                "0 on ScanNet); ms, plain_ms and bound_ms sum the B = 1 "
                "step's launches")
        if kname in PROBES:
            entry["probe"] = ("a probe of kernel C, off the main path: 0 "
                              "launches there; ms, plain_ms and bound_ms sum "
                              "its cases")
        record["kernels"].append(entry)
    for kname, r in res16.items():
        src, repl = REPO_SOURCES[kname]
        route = "mapped" if kname.startswith("mapped") else "keyed"
        bf16 = configs["bf16"]
        record["kernels"].append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": bf16["train_launches"][route][kname],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library": "none: " + LIBRARY_NONE[kname],
            "form": "bf16 (compute_dtype='bfloat16')",
            "f32_ms": r["f32_ms"], "cases": r["cases"],
            "bound_f32_ms": r["bound_f32_ms"],
            "bound_note": r["bound_note"],
            "launches_note": "per train step of the bf16 model on its route "
                             "(0 on the f32 path)",
            "train_step_device_ms": bf16_step_ms(bf16["train"][route],
                                                 kname),
            "launches_by_route": {
                rt: {"bf16_eval_step": bf16["eval_launches"][rt][kname],
                     "bf16_train_step": bf16["train_launches"][rt][kname]}
                for rt in ROUTES}})
    record["forward_ms_per_scene"] = {
        route: {f"B={b}": t for b, t in per_scene[route].items()}
        for route in ROUTES}
    record["eval_step"] = {
        route: {f"B={b}": v for b, v in eval_per[route].items()}
        for route in ROUTES}
    record["ap_end_to_end"] = ap
    record["fpn_mapped_vs_keyed_max_abs_err"] = fpn_err
    record["train"] = train
    record["cli"] = cli
    record["sunrgbd"] = {
        "eval_step": {route: {f"B={b}": v for b, v in sun_eval[route].items()}
                      for route in ROUTES},
        "ap_end_to_end": {"device_nms": sun_ap, "rotated_nms": sun_ap_rot},
        "train": sun_train, "iou_types": sun_iou, "cli": sun_cli}
    for kname, r in seq.get("sharded", {}).items():
        base = kname[:-len("_sharded")]
        src, repl = REPO_SOURCES[base]
        record["kernels"].append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": repl + " (its key-sharded use: the JAX package's "
            "seq path materializes each shard's bias in XLA instead, "
            "vdetr_tpu/models/transformer.py:345-358)",
            "launches": (seq_ranks[0]["steps"][0][3][base]
                         if seq_ranks else 0),
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library": "none: " + LIBRARY_NONE[base],
            "form": "per key shard, the shards merged by their log-sum-exps "
                    "(2 shards: 2 launches and the merge)",
            "ms_dropout0": r["ms_dropout0"], "shape": r["shape"],
            "launches_note": "per seq train step of rank 0 of mesh (1, 2) "
                             "at 200000 points a scene (phase 11)"})
    record["data_parallel"] = dp
    record["seq"] = seq
    record["configurations"] = configs
    record["card"] = smi
    record["seconds"] = time.perf_counter() - start
    log(json.dumps(record))
    if not (all(r["ok"] for r in res.values())
            and all(r["ok"] for r in res16.values()) and ok_f and ok_fpn
            and ok_s and ok_e and ok_ap and ok_se and ok_t and ok_ts and ok_c
            and ok_sev and ok_sap and ok_sapr and all(ok_ss) and ok_st
            and ok_si and ok_sc and ok_dp and ok_cfg and ok_seq):
        log("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
