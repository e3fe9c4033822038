"""A/B of two source trees of the port on one card, in turns.

    python -m vdetr_tpu_torch.tools.ab_kernels [--only PART,...] TREE ...

Runs the measurement below once per TREE, in the order given, each in a
child process whose working directory and import path are that tree (so
it builds and imports that tree's kernels and `chip_smoke.py`): give a
parent and a change as `parent change change parent` to compare them
within one call. A tree is a checkout of the repository, e.g. the parent
commit unpacked with `git archive` into an ignored directory. Per tree,
on the published shapes and model (`VDETRConfig()`, seeded random
weights, synthetic scenes):
- the sparse-conv kernels A (keyed) and H (mapped) and their weight
  gradients D (keyed) and I (mapped), each in its f32 and its bf16 form
  (chip_smoke's `bf16_cases`), on chip_smoke's four conv cases: ms per
  launch (CUDA events, mean of 20), the error against the plain version
  (and over the plain version's max|ref|), the device ms of each kernel
  the call launches (torch.profiler, per call), and a digest of the
  output's bits (equal digests: two trees computed the same bits on the
  same seeded inputs);
- the RPE forward C in its eval form and its train form (dropout 0.1,
  lse and logits) on chip_smoke's decoder-shaped case: ms per launch
  (mean of 10), the error against the plain version and a digest of the
  outputs' bits;
- the flash-RPE backward F at dropout 0 and 0.1 (dq, dtables, ds and eg
  digested): ms per launch, and its
  pair kernel, the sum of the pair kernel's key shares, its table kernel
  and the sum of the table kernel's slices (a tree that has them) apart
  (torch.profiler, device ms per call), and whether a second call gives
  dTables bit for bit;
- the sum of F's table slices alone (a tree that has it), 64 slices:
  device ms of the kernel and of `torch.sum(slices, 0)`;
- the neighbour maps G of one mapped forward, at B = 1 and B = 4, as the
  tree's backbone launches them (`measure_maps`): ms for the set by CUDA
  events, device us per launch and the device gaps between launches;
- the table-contraction probe J2 on the tool's five variants: ms per
  launch (CUDA events, mean of 20), device ms per launch
  (torch.profiler), and the einsum with TF32 off and on;
- FPS, kernel B, on its main-path input (the stride-4 level's 32768
  voxel centres sampled to 4096) of one scene (B = 1) and of the four
  rows of an eval batch (B = 4): ms per launch (mean of 10) and the
  indices that differ from the plain version;
- one eval forward per route at batch 1 under torch.profiler: device ms
  and launches per port kernel;
- chip_smoke's `run_forward` (ms per scene at batch 1 and 4) and
  `run_train` (median train step, one profiled step per route, F's
  kernels apart);
- the device NMS, kernel N, through the tree's `nms_launch` on
  `tools/nms_cases.py`'s sets at K = 1024, B = 1 and 4, and on one fixed
  seeded set of published-like boxes (`published_like_boxes`): ms per
  launch (CUDA events, the sort included), device ms per call of each
  kernel it launches (the barrier scan of a parent, the mask and scan
  kernels of the bitmask form), the plain loop's ms, and a digest of
  the keep mask's bits;
- chip_smoke's `run_eval`: the published eval step (`test_only`) per
  route at B = 1 and 4, ms per scene of the step and of the forward;
- the rotated GIoU's areas, kernel R, forward and backward on each job
  of the published SUN RGB-D criterion (`chip_smoke.rotated_inputs`: 9
  jobs, the cotangents of that step's backward) at B = 1 and 4: ms per
  launch (CUDA events, mean of 20), device ms per launch (torch.profiler)
  and their sums over a step's jobs, and a digest of the inputs' and of
  each output's bits;
- the auction, kernel M, on the published criterion's two shape groups
  at B = 1 and 4 (`chip_smoke.matcher_inputs`) and on chip_smoke's edge
  cases (ties, duplicated rows, a cut at max_iters): ms per launch (CUDA
  events), device ms per launch, the rounds, ms a round, and a digest of
  col4row's and the rounds' bits;
- the published model with the bf16 backbone (compute_dtype="bfloat16")
  per route: one eval forward and one train step at B = 1 under
  torch.profiler, device ms and launches per port kernel (the bf16
  forms of A and H apart from the train step's f32 dFeats convs).
The parts (PARTS) run in that order; `--only` names the ones to run.
Prints one JSON line per tree (`ab_kernels {...}`) and a summary table
last; the card's name and power limit beside it. Needs the card.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

# device kernel names -> what they are, for every tree measured
KERNEL_NAMES = (("neighbour_map_kernel", "D private map"),
                ("dw_rulebook_kernel", "D/I rulebook"),
                ("conv_sum_splits_kernel", "A/H split sums"),
                ("conv_sum_live_splits_kernel", "A/H bf16 split sums"),
                ("dw_sum_splits_kernel", "D/I split sums"),
                ("sum_splits_kernel", "split sums"),
                ("dw_kernel", "D/I dW GEMM"),
                ("dw_bf16_kernel", "D/I dW GEMM"),
                ("keyed_conv_bf16_kernel", "A bf16"),
                ("mapped_conv_bf16_kernel", "H bf16"),
                # a tree whose bf16 forms are instances of the f32 kernels
                ("keyed_conv_kernel<__nv_bfloat16", "A bf16"),
                ("mapped_conv_kernel<__nv_bfloat16", "H bf16"),
                ("keyed_conv_kernel", "A"),
                ("mapped_conv_kernel", "H"),
                ("map_kernel", "G"),
                ("fps_kernel", "B"),
                ("rpe_attention_kernel", "C"),
                ("rpe_pair_bwd_kernel", "F pair"),
                ("rpe_dq_sum_kernel", "F dq sum"),
                ("rpe_table_bwd_kernel", "F table"),
                ("rpe_table_sum_kernel", "F table sum"),
                ("dot_micro_kernel", "J2"),
                ("nms_mask_kernel", "N mask"),
                ("nms_scan_kernel", "N scan"),
                ("rotated_areas_bwd_kernel", "R backward"),
                ("rotated_areas_kernel", "R forward"),
                ("auction_kernel", "M"))
PARTS = ("conv", "rpe", "table_sum", "fps", "maps", "dot_micro", "forward",
         "train", "nms", "eval", "rotated", "auction", "bf16_step")


def _label(name: str):
    return next((lab for pat, lab in KERNEL_NAMES if pat in name), None)


def profiled_calls(fn, reps: int, keep=lambda event: True):
    """The device events of `reps` calls of `fn`, one torch.profiler
    session a call: per call a list of (name, start us, end us), of the
    CUDA events that `keep` accepts. A session that caught fewer of them
    than the most any caught (the profiler can drop a call's events) is
    taken again; after 3 x reps sessions the fullest `reps` are kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    calls = []
    for _ in range(3 * reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        calls.append(sorted(
            ((e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False) and keep(e)),
            key=lambda x: x[1]))
        most = max(len(c) for c in calls)
        if sum(len(c) == most for c in calls) >= reps:
            break
    return sorted(calls, key=len, reverse=True)[:reps]


def profile_by_kernel(fn, reps: int = 1):
    """{label: [device ms per call, launches per call]} of the port's
    kernels that `fn` launches (torch.profiler, one session per warm
    call, `profiled_calls`)."""
    calls = profiled_calls(fn, reps, keep=lambda e: _label(e.name))
    out = {}
    for call in calls:
        for name, a, z in call:
            lab = _label(name)
            ms, n = out.get(lab, (0.0, 0))
            out[lab] = (ms + (z - a) / 1e3 / len(calls),
                        n + 1 / len(calls))
    return {k: [ms, n] for k, (ms, n) in out.items()}


def measure(parts=PARTS) -> dict:
    """The measurement of the tree in the working directory: the PARTS
    named in `parts`."""
    import torch

    import chip_smoke as cs
    from vdetr_tpu_torch import kernels
    from vdetr_tpu_torch.config import VDETRConfig
    from vdetr_tpu_torch.tools import card

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.build_all()
    smi = card()
    res = {"tree": os.getcwd(), "card": smi, "parts": list(parts)}
    cfg = VDETRConfig()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    if "conv" in parts:
        res["conv"] = measure_convs(cfg, dev, cs, gen)
    if "rpe" in parts:
        res.update(measure_rpe(cfg, dev, cs, gen))
    if "table_sum" in parts:
        res["table_sum"] = measure_table_sum(cfg, dev)
    if "fps" in parts:
        res["fps"] = measure_fps(cfg, dev, cs)
    if "maps" in parts:
        res["maps"] = measure_maps(cfg, dev, cs)
    if "dot_micro" in parts:
        res["dot_micro"] = measure_dot_micro(dev)
    if "nms" in parts:
        res["nms"] = measure_nms(dev, cs)
    if "rotated" in parts:
        res["rotated"] = measure_rotated(dev, cs)
    if "auction" in parts:
        res["auction"] = measure_auction(cfg, dev, cs)
    if "bf16_step" in parts:
        res["bf16_step"] = measure_bf16_step(cfg, dev, cs)
    torch.cuda.empty_cache()
    ok = True
    if {"forward", "eval"} & set(parts):
        models = {r: cs.published_model(cfg, dev, r) for r in cs.ROUTES}
    if "forward" in parts:
        inputs = cs.synthetic_batch(cfg.num_points, 1, dev)
        with torch.inference_mode():
            res["forward_profile"] = {
                r: profile_by_kernel(lambda: m(inputs))
                for r, m in models.items()}
        ok_f, _, per_scene = cs.run_forward(models, cfg, dev, smi)
        res["forward_ms_per_scene"] = {
            r: {str(b): t for b, t in v.items()}
            for r, v in per_scene.items()}
        ok &= bool(ok_f)
    if "eval" in parts:
        ok_e, _, per, _, trainers = cs.run_eval(
            models, cs.eval_config(cfg), dev, smi)
        res["eval_step"] = {
            r: {str(b): {k: v[k] for k in ("step_ms_per_scene",
                                           "forward_ms_per_scene", "kept")}
                for b, v in per[r].items()} for r in cs.ROUTES}
        ok &= bool(ok_e)
        del trainers
    if {"forward", "eval"} & set(parts):
        del models
        torch.cuda.empty_cache()
    if "train" in parts:
        ok_t, _, train = cs.run_train(
            cfg, dev, smi, variants={r: (r, "jv") for r in cs.ROUTES})
        res["train"] = {
            r: {"ms_per_step": train[r]["ms_per_step"],
                "steps": train[r]["steps"],
                "device_busy_ms": train[r]["profile"]["device_busy_ms"],
                "busy_share": train[r]["profile"]["busy_share"],
                "by_kernel": train[r]["profile"]["by_kernel"],
                "by_part": train[r]["profile"]["by_part"]}
            for r in cs.ROUTES}
        ok &= bool(ok_t)
    res["ok"] = ok and all(c["mismatches"] == 0
                           for c in res.get("nms", {}).values())
    return res


def measure_convs(cfg, dev, cs, gen) -> dict:
    """A, H, D and I on chip_smoke's conv cases."""
    from vdetr_tpu_torch.ops.sparse_conv_kernel import (
        mapped_conv, mapped_conv_dw, mapped_conv_dw_plain, mapped_conv_plain)
    from vdetr_tpu_torch.ops.sparse_conv_keyed import (
        keyed_conv, keyed_conv_dw, keyed_conv_dw_plain, keyed_conv_plain)
    from vdetr_tpu_torch.tools import time_ms

    out = {}
    grids = cs.level_grids(cfg, dev)
    cases = cs.conv_cases(cfg, grids, gen)
    for case, case16 in zip(cases, cs.bf16_cases(cases)):
        label, dout, nbr = case[0], case[2], case[4]
        row = {}
        for form, args in (("", case[1]), (" bf16", case16[1])):
            for name, fn, plain, a in (
                    ("A", keyed_conv, keyed_conv_plain, args),
                    ("H", mapped_conv, mapped_conv_plain,
                     (args[0], nbr, args[5])),
                    ("D", keyed_conv_dw, keyed_conv_dw_plain,
                     args[:5] + (dout,)),
                    ("I", mapped_conv_dw, mapped_conv_dw_plain,
                     (args[0], nbr, dout))):
                ref = plain(*a)
                got = fn(*a)
                err = float((got - ref).abs().max())
                max_ref = float(ref.abs().max())
                row[name + form] = {
                    "ms": time_ms(lambda: fn(*a), reps=20),
                    "max_abs_err": err, "rel_err": err / max_ref,
                    "sha256": digest(got), "max_ref": max_ref,
                    "parts": profile_by_kernel(lambda: fn(*a), reps=5)}
        out[label] = row
    return out


def measure_bf16_step(cfg, dev, cs) -> dict:
    """The published model with the bf16 backbone (compute_dtype=
    "bfloat16", the auction) per route: one eval forward at B = 1 and one
    train step at B = 1 (after two warm steps), each under torch.profiler:
    {"forward" | "train": {label: [device ms, launches]}} of the port's
    kernels (KERNEL_NAMES; a train step's f32 dFeats convs are "A" or
    "H", their split sums in "A/H split sums")."""
    import torch

    from vdetr_tpu_torch.train.engine import Trainer

    cfg16 = cfg.replace(compute_dtype="bfloat16")
    inputs = cs.synthetic_batch(cfg16.num_points, 1, dev)
    batch = cs.train_batch(cfg16, 1)
    out = {}
    for route in cs.ROUTES:
        model = cs.published_model(cfg16, dev, route)
        with torch.inference_mode():
            fwd = profile_by_kernel(lambda: model(inputs), reps=3)
        trainer = Trainer(cfg16, model, cs.dataset_of(cfg16),
                          steps_per_epoch=1000, device=dev)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        for _ in range(2):
            trainer.train_step(batch, gen)
        out[route] = {"forward": fwd, "train": profile_by_kernel(
            lambda: trainer.train_step(batch, gen), reps=3)}
        del model, trainer
        torch.cuda.empty_cache()
    return out


def measure_rpe(cfg, dev, cs, gen) -> dict:
    """C in its eval and train forms and F at dropout 0 and 0.1."""
    import torch

    from vdetr_tpu_torch.ops.rpe_attention import (
        rpe_cross_attention, rpe_cross_attention_bwd,
        rpe_cross_attention_bwd_plain, rpe_cross_attention_plain)
    from vdetr_tpu_torch.tools import time_ms

    res = {"rpe_fwd": {}, "rpe_bwd": {}}
    case = cs.rpe_case(cfg, dev, gen)
    q, k, v, corners, angles, key_xyz, tables, key_valid = case
    for form, extra in (("eval", {}),
                        ("train", dict(dropout_rate=0.1, return_stats=True,
                                       seed=torch.tensor(
                                           [12345], dtype=torch.int64,
                                           device=dev)))):
        ckw = dict(log_scale=cfg.log_scale, max_value=cfg.rpe_max_value,
                   **extra)
        got = rpe_cross_attention(*case, **ckw)
        ref = rpe_cross_attention_plain(*case, **ckw)
        sha = digest(*(got if isinstance(got, tuple) else (got,)))
        got, ref = (x[0] if isinstance(x, tuple) else x for x in (got, ref))
        res["rpe_fwd"][form] = {
            "ms": time_ms(lambda: rpe_cross_attention(*case, **ckw), reps=10),
            "max_abs_err": float((got - ref).abs().max()), "sha256": sha}
        del got, ref
    seed = torch.tensor([777], dtype=torch.int64, device=dev)
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=dev).manual_seed(cs.SEED + 7), device=dev)
    for rate in (0.0, 0.1):
        fkw = dict(log_scale=cfg.log_scale, max_value=cfg.rpe_max_value,
                   dropout_rate=rate, seed=seed)
        out, lse, logits = rpe_cross_attention_plain(*case, return_stats=True,
                                                     **fkw)
        a = (k, v, corners, angles, key_xyz, key_valid, out, dout, logits,
             lse, tables.shape[1])
        got = rpe_cross_attention_bwd(*a, **fkw)
        again = rpe_cross_attention_bwd(*a, **fkw)
        ref = rpe_cross_attention_bwd_plain(*a, **fkw)
        errs = {n: float((g - r).abs().max()) for n, g, r in
                zip(("dq", "dtables", "ds", "eg"), got, ref)}
        dtables_repeat = bool(torch.equal(got[1], again[1]))
        del again
        res["rpe_bwd"][str(rate)] = {
            "ms": time_ms(lambda: rpe_cross_attention_bwd(*a, **fkw),
                          reps=10),
            "parts": profile_by_kernel(
                lambda: rpe_cross_attention_bwd(*a, **fkw), reps=5),
            "max_abs_err": errs, "dtables_bit_equal": dtables_repeat,
            "sha256": digest(*got)}
        del got, ref, out, lse, logits
    return res


def published_like_boxes(seed: int = 0, B: int = 1, K: int = 1024):
    """One fixed set of NMS inputs shaped like a published eval step's
    (numpy, from `seed`): K proposals a scene clustered around 24
    objects in an 8 x 8 x 3 m scan (the queries of a decoder crowd its
    objects), sizes 0.2-2 m jittered per proposal, one of 18 classes per
    object with one proposal in five of another, scores in (0.6, 0.8)
    with a few exact ties, and a third of the boxes left out as the
    empty-box removal leaves them. Returns (aabbs (B, K, 6) float32,
    scores (B, K) float32, classes (B, K) int32, valid (B, K) bool)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    objs = 24
    centre = rng.rand(B, objs, 3) * [8.0, 8.0, 3.0]
    size = 0.2 + rng.rand(B, objs, 3) * 1.8
    cls = rng.randint(0, 18, (B, objs))
    of = rng.randint(0, objs, (B, K))
    take = np.take_along_axis
    c = take(centre, of[..., None], 1) + rng.randn(B, K, 3) * 0.15
    s = take(size, of[..., None], 1) * (0.8 + 0.4 * rng.rand(B, K, 3))
    classes = take(cls, of, 1)
    other = rng.rand(B, K) < 0.2
    classes[other] = rng.randint(0, 18, int(other.sum()))
    scores = 0.6 + 0.2 * rng.rand(B, K)
    scores[:, 1::16] = scores[:, ::16][:, :scores[:, 1::16].shape[1]]
    aabbs = np.concatenate([c - s / 2, c + s / 2], -1).astype(np.float32)
    valid = rng.rand(B, K) >= 1 / 3
    return (aabbs, scores.astype(np.float32), classes.astype(np.int32),
            valid)


def measure_nms(dev, cs) -> dict:
    """Kernel N through the tree's `nms_launch` on `nms_cases` at K =
    1024, B = 1 and 4, and on `published_like_boxes` at B = 1 and 4: ms
    per launch (CUDA events, mean of 20), device ms per call of each
    kernel launched (torch.profiler, 5 calls), the plain loop's ms, the
    keep flags that differ from it and a digest of the keep mask's bits
    (equal digests: two trees kept the same boxes)."""
    import time

    import numpy as np
    import torch

    from vdetr_tpu_torch.geometry.nms import (nms_3d_samecls_mask_plain,
                                              nms_launch)
    from vdetr_tpu_torch.tools import time_ms
    from vdetr_tpu_torch.tools.nms_cases import nms_cases

    sets = {}
    rng = np.random.RandomState(cs.SEED)
    for B in (1, 4):
        sets[f"nms_cases B={B} K=1024"] = nms_cases(rng, B, 1024)
    for B in (1, 4):
        sets[f"published-like B={B} K=1024"] = published_like_boxes(7, B)
    out = {}
    for label, arrays in sets.items():
        args = [torch.from_numpy(a).to(dev) for a in arrays]

        def run():
            return nms_launch(*args, 0.25)

        got = run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = nms_3d_samecls_mask_plain(*args, 0.25)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        calls = profiled_calls(run, 5, keep=lambda e: "nms_" in e.name)
        parts = {}
        for call in calls:
            for name, a, z in call:
                lab = _label(name) or name
                parts[lab] = parts.get(lab, 0.0) + (z - a) / 1e3 / len(calls)
        out[label] = {
            "ms": time_ms(run, reps=20), "device_ms": parts,
            "plain_ms": plain_ms, "mismatches": int((got != ref).sum()),
            "kept": int(got.sum()),
            "keep_sha256": digest(got)}
    return out


def digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def kernel_device_ms(fn, label: str, reps: int = 5) -> float:
    """Device ms per call of the launches of `fn` labelled `label`
    (KERNEL_NAMES; torch.profiler, one profile a call)."""
    calls = profiled_calls(fn, reps, keep=lambda e: _label(e.name) == label)
    return sum(z - a for c in calls for _, a, z in c) / 1e3 / len(calls)


def measure_rotated(dev, cs) -> dict:
    """Kernel R through the tree's `rotated_areas_launch` and
    `rotated_areas_bwd_launch` on each job of the published SUN RGB-D
    criterion at B = 1 and 4: per job ms per launch (CUDA events, mean of
    20) and device ms per launch, forward and backward, and digests of
    the inputs and of each output's bits; per B the sums over the jobs (a
    train step launches each once)."""
    import torch

    from vdetr_tpu_torch.ops.rotated_iou import (rotated_areas_bwd_launch,
                                                 rotated_areas_launch)
    from vdetr_tpu_torch.tools import time_ms

    out = {}
    for B in (1, 4):
        jobs = cs.rotated_inputs(cs.sun_config(), dev, B)
        torch.cuda.empty_cache()
        rows, total = [], {"ms": 0.0, "bwd_ms": 0.0, "device_ms": 0.0,
                           "bwd_device_ms": 0.0}
        for job in jobs:
            r1, r2, gate, g = (job[k] for k in ("rect1", "rect2", "gate",
                                                "grad"))

            def fwd():
                return rotated_areas_launch(r1, r2, gate)

            def bwd():
                return rotated_areas_bwd_launch(r1, r2, gate, g)

            row = {"shape": list(gate.shape),
                   "inputs_sha256": digest(r1, r2, gate, g),
                   "forward_sha256": digest(fwd()),
                   "backward_sha256": digest(bwd()),
                   "ms": time_ms(fwd, reps=20),
                   "bwd_ms": time_ms(bwd, reps=20),
                   "device_ms": kernel_device_ms(fwd, "R forward"),
                   "bwd_device_ms": kernel_device_ms(bwd, "R backward")}
            for k in total:
                total[k] += row[k]
            rows.append(row)
        total["forward_sha256"] = digest(*(rotated_areas_launch(
            j["rect1"], j["rect2"], j["gate"]) for j in jobs))
        total["backward_sha256"] = digest(*(rotated_areas_bwd_launch(
            j["rect1"], j["rect2"], j["gate"], j["grad"]) for j in jobs))
        total["inputs_sha256"] = digest(*(j[k] for j in jobs for k in (
            "rect1", "rect2", "gate", "grad")))
        out[str(B)] = {"jobs": rows, "step": total}
        del jobs
        torch.cuda.empty_cache()
    return out


def measure_auction(cfg, dev, cs) -> dict:
    """Kernel M through the tree's `auction_launch` on the published
    criterion's shape groups at B = 1 and 4 and on chip_smoke's edge
    cases: ms per launch (CUDA events), device ms per launch, the rounds
    of each problem, ms a round (the device ms over the most rounds of a
    problem: the problems run side by side), and a digest of col4row's
    and the rounds' bits."""
    import torch

    from vdetr_tpu_torch.ops.hungarian import auction_launch
    from vdetr_tpu_torch.tools import time_ms

    cases = []
    for B in (1, 4):
        for kind, cost, nv, rep in cs.matcher_inputs(cfg, dev, B):
            cases.append((f"criterion B={B} {kind} {tuple(cost.shape)}",
                          cost, nv, rep))
    cases += list(cs.auction_edge_cases(dev))
    out = {}
    for name, cost, nv, rep in cases:
        def run():
            return auction_launch(cost, nv, rep)

        col4row, rounds = run()
        few = int(rounds.max()) < 100
        dev_ms = kernel_device_ms(run, "M", reps=5 if few else 2)
        out[name] = {"shape": list(cost.shape), "repeat": rep,
                     "rounds": rounds.tolist(),
                     "inputs_sha256": digest(cost, nv),
                     "sha256": digest(col4row, rounds),
                     "ms": time_ms(run, reps=20 if few else 3),
                     "device_ms": dev_ms,
                     "ms_per_round": dev_ms / max(int(rounds.max()), 1)}
    step = [v for k, v in out.items() if k.startswith("criterion B=1 ")]
    out["step B=1"] = {"ms": sum(v["ms"] for v in step),
                       "device_ms": sum(v["device_ms"] for v in step),
                       "sha256": "".join(v["sha256"][:4] for v in step)}
    return out


def map_launches(grids):
    """The neighbour maps of one mapped forward over `grids` (raw, stem,
    stages 1-4), launched the way this tree's backbone builds them: a
    function that runs them once. A tree with `kernel_map_pair` builds
    each stage's stride-2 map and level map in one launch (five launches
    in all); an older tree runs nine `kernel_map` calls."""
    from vdetr_tpu_torch.ops import map_kernel as mk

    pair = getattr(mk, "kernel_map_pair", None)
    stem_in, stem = grids[0], grids[1]

    def run():
        mk.kernel_map(stem_in.keys, (stem.coords * 2).contiguous(),
                      stem.valid, stem_in.extent)
        for fine, coarse in zip(grids[1:-1], grids[2:]):
            if pair is not None:
                pair(fine.keys, fine.extent, coarse.keys, coarse.coords,
                     coarse.valid, coarse.extent)
            else:
                mk.kernel_map(fine.keys, (coarse.coords * 2).contiguous(),
                              coarse.valid, fine.extent)
                mk.kernel_map(coarse.keys, coarse.coords, coarse.valid,
                              coarse.extent)

    return run


def measure_maps(cfg, dev, cs, reps: int = 20) -> dict:
    """Kernel G on the maps of one mapped forward (`map_launches`) at B = 1
    and B = 4: ms for the whole set by CUDA events (mean of `reps` sets,
    each launch from the host as the forward makes it), and under
    torch.profiler the device us of each launch, the device gaps between
    consecutive launches of a set, and the set's device span."""
    from vdetr_tpu_torch.tools import time_ms

    out = {}
    for batch in (1, 4):
        run = map_launches(cs.level_grids(cfg, dev, batch))
        ms = time_ms(run, reps=reps)
        sets = profiled_calls(run, 5, keep=lambda e: "map_kernel" in e.name)
        per_set = len(sets[0])
        gaps = [s[i + 1][1] - s[i][2] for s in sets
                for i in range(len(s) - 1)]
        out[str(batch)] = {
            "event_ms": ms, "launches": per_set,
            "device_us_per_launch": [
                sum(s[i][2] - s[i][1] for s in sets) / len(sets)
                for i in range(per_set)],
            "device_us_sum": sum(z - a for s in sets for _, a, z in s)
            / len(sets),
            "gap_us_mean": sum(gaps) / len(gaps) if gaps else 0.0,
            "span_us": sum(s[-1][2] - s[0][1] for s in sets if s)
            / len(sets)}
    return out


def measure_table_sum(cfg, dev) -> dict:
    """The sum of F's table slices (a tree that has it) at the published
    shape, 64 slices: device ms per call of the kernel and of
    `torch.sum(slices, 0)` (one session per call, `profiled_calls`)."""
    import torch

    from vdetr_tpu_torch.ops import rpe_attention as ra

    if not hasattr(ra, "rpe_table_sum"):
        return {}
    n, H = cfg.rpe_table_size, cfg.dec_nhead
    slices = torch.randn(64, 8, n, n, n, H, device=dev)

    def ms(fn):
        calls = profiled_calls(fn, 10)
        return sum(z - a for c in calls for _, a, z in c) / 1e3 / len(calls)

    return {"device_ms": ms(lambda: ra.rpe_table_sum(slices)),
            "library_device_ms": ms(lambda: torch.sum(slices, 0))}


def measure_dot_micro(dev) -> list:
    """Probe J2 on the tool's five variants: the tool's own timing rows
    (kernel, plain version, einsum TF32 off and on; CUDA events, and the
    device ms of each where the tree's tool has them) and the kernel's
    device ms per launch (torch.profiler)."""
    from vdetr_tpu_torch.tools import dot_micro as tdm

    cases = tdm.make_inputs(dev)
    rows = tdm.run_variants(cases, reps=20)
    for row, (_, T, P, _) in zip(rows, cases):
        parts = profile_by_kernel(lambda: tdm.dot_micro(T, P), reps=5)
        row["device_ms"] = parts.get("J2", [None])[0]
    return rows


def measure_fps(cfg, dev, cs) -> dict:
    """Kernel B at B = 1 and B = 4 on its main-path input. Builds the
    input from `cs.synthetic_batch` and the voxel ops, which every tree
    has (a parent's `chip_smoke.level_grids` may take no batch)."""
    import torch

    from vdetr_tpu_torch.ops.fps import fps_plain, furthest_point_sample
    from vdetr_tpu_torch.ops.voxelize import downsample_grid, voxelize
    from vdetr_tpu_torch.tools import time_ms

    out = {}
    for batch in (1, 4):
        inp = cs.synthetic_batch(cfg.num_points, batch, dev)
        caps = cfg.stage_capacities()
        g = voxelize(inp["point_clouds"], inp["point_clouds"],
                     inp["point_validity"], voxel_size=cfg.voxel_size,
                     capacity=caps[0], extent=cfg.grid_extent)
        for cap in caps[1:3]:
            g = downsample_grid(g, cap)
        xyz = (g.world_xyz() * g.valid[..., None]).contiguous()
        npoint = cfg.preenc_npoints
        got = furthest_point_sample(xyz, npoint)
        ref = fps_plain(xyz, npoint)
        out[str(batch)] = {
            "ms": time_ms(lambda: furthest_point_sample(xyz, npoint),
                          reps=10),
            "mismatches": int((got != ref).sum())}
    return out


def summary(runs) -> list:
    """One line per measured quantity, one column per run."""
    def col(f):
        vals = []
        for r in runs:
            try:
                vals.append(f"{f(r):.4f}")
            except (KeyError, TypeError):
                vals.append("-")
        return " | ".join(vals)

    lines = ["| quantity | " + " | ".join(
        Path(r["tree"]).name or r["tree"] for r in runs) + " |"]
    has = set(runs[0])
    conv_keys = ("A", "H", "D", "I", "A bf16", "H bf16", "D bf16", "I bf16")
    for label in runs[0].get("conv", {}):
        for k in conv_keys:
            lines.append(f"| {k} ms {label} | "
                         + col(lambda r: r["conv"][label][k]["ms"]) + " |")
            lines.append(f"| {k} max|diff| / max|ref| {label} | " + " | ".join(
                f"{r['conv'][label][k]['rel_err']:.2e}" if k in r["conv"][label]
                else "-" for r in runs) + " |")
            parts = sorted({p for r in runs
                            for p in r["conv"][label].get(k, {}).get(
                                "parts", {})})
            for part in parts:
                lines.append(f"| {k} {label}: {part} device ms | " + col(
                    lambda r: r["conv"][label][k]["parts"][part][0]) + " |")
    for label in runs[0].get("conv", {}):
        for k in conv_keys:
            lines.append(f"| {k} output sha256 {label} | " + " | ".join(
                r["conv"][label].get(k, {}).get("sha256", "-") for r in runs)
                + " |")
    for form in ("eval", "train") if "rpe_fwd" in has else ():
        lines.append(f"| C ms {form} form | "
                     + col(lambda r: r["rpe_fwd"][form]["ms"]) + " |")
    for rate in ("0.0", "0.1") if "rpe_bwd" in has else ():
        lines.append(f"| F ms dropout {rate} | "
                     + col(lambda r: r["rpe_bwd"][rate]["ms"]) + " |")
        for part in ("F pair", "F dq sum", "F table", "F table sum"):
            lines.append(f"| {part} device ms dropout {rate} | " + col(
                lambda r: r["rpe_bwd"][rate]["parts"][part][0]) + " |")
        lines.append(f"| F dTables bit-equal twice dropout {rate} | " + " | "
                     .join(str(r["rpe_bwd"][rate].get("dtables_bit_equal",
                                                      "-")) for r in runs)
                     + " |")
    for key in ("device_ms", "library_device_ms") if "table_sum" in has \
            else ():
        lines.append(f"| F table sum alone {key} | " + col(
            lambda r: r["table_sum"][key]) + " |")
    for batch in ("1", "4") if "maps" in has else ():
        for key in ("event_ms", "device_us_sum", "gap_us_mean", "span_us",
                    "launches"):
            lines.append(f"| G maps of a forward B={batch} {key} | " + col(
                lambda r: r["maps"][batch][key]) + " |")
    for i, row in enumerate(runs[0].get("dot_micro", [])):
        for key in ("ms", "device_ms", "library_ms", "library_tf32_ms",
                    "library_device_ms", "library_tf32_device_ms"):
            lines.append(f"| J2 {row['case']} {key} | " + col(
                lambda r: r["dot_micro"][i][key]) + " |")
    for batch in ("1", "4") if "fps" in has else ():
        lines.append(f"| B ms B={batch} | "
                     + col(lambda r: r["fps"][batch]["ms"]) + " |")
        lines.append(f"| B indices differing B={batch} | "
                     + col(lambda r: r["fps"][batch]["mismatches"]) + " |")
    for label in runs[0].get("nms", {}):
        for key in ("ms", "plain_ms", "mismatches", "kept"):
            lines.append(f"| N {label} {key} | " + col(
                lambda r: r["nms"][label][key]) + " |")
        for part in sorted({p for r in runs
                            for p in r.get("nms", {}).get(label, {}).get(
                                "device_ms", {})}):
            lines.append(f"| N {label} {part} device ms | " + col(
                lambda r: r["nms"][label]["device_ms"][part]) + " |")
        lines.append(f"| N {label} keep sha256 | " + " | ".join(
            r.get("nms", {}).get(label, {}).get("keep_sha256", "-")
            for r in runs) + " |")
    for B in ("1", "4") if "rotated" in has else ():
        for key in ("ms", "bwd_ms", "device_ms", "bwd_device_ms"):
            lines.append(f"| R step B={B} {key} | " + col(
                lambda r: r["rotated"][B]["step"][key]) + " |")
        for key in ("inputs_sha256", "forward_sha256", "backward_sha256"):
            lines.append(f"| R step B={B} {key} | " + " | ".join(
                r.get("rotated", {}).get(B, {}).get("step", {}).get(key, "-")
                for r in runs) + " |")
        for i, job in enumerate(runs[0]["rotated"][B]["jobs"]):
            for key in ("device_ms", "bwd_device_ms"):
                lines.append(f"| R B={B} job {i} {key} | " + col(
                    lambda r: r["rotated"][B]["jobs"][i][key]) + " |")
    for label in runs[0].get("auction", {}):
        keys = (("ms", "device_ms", "sha256") if label.startswith("step")
                else ("ms", "device_ms", "ms_per_round", "sha256"))
        for key in keys:
            if key == "sha256":
                lines.append(f"| M {label} sha256 | " + " | ".join(
                    r.get("auction", {}).get(label, {}).get(key, "-")
                    for r in runs) + " |")
            else:
                lines.append(f"| M {label} {key} | " + col(
                    lambda r: r["auction"][label][key]) + " |")
    for route in ("keyed", "mapped") if "eval_step" in has else ():
        for b in ("1", "4"):
            for key in ("step_ms_per_scene", "forward_ms_per_scene"):
                lines.append(f"| eval step {route} B={b} {key} | " + col(
                    lambda r: r["eval_step"][route][b][key]) + " |")
    for route in ("keyed", "mapped") if "forward_profile" in has else ():
        for lab in ("A", "H", "C", "B", "G"):  # C: one launch per layer
            lines.append(f"| forward {route} B=1 {lab} device ms | " + col(
                lambda r: r["forward_profile"][route][lab][0]) + " |")
        for b in (1, 4):
            lines.append(f"| forward {route} ms/scene B={b} | " + col(
                lambda r: r["forward_ms_per_scene"][route][str(b)]) + " |")
    for route in ("keyed", "mapped") if "bf16_step" in has else ():
        for step in ("forward", "train"):
            for lab in sorted({k for r in runs
                               for k in r["bf16_step"][route][step]}):
                for i, what in ((0, "device ms"), (1, "launches")):
                    lines.append(f"| bf16 {step} {route} B=1 {lab} {what} | "
                                 + col(lambda r: r["bf16_step"][route][step]
                                       [lab][i]) + " |")
    for route in ("keyed", "mapped") if "train" in has else ():
        lines.append(f"| train {route} median step ms | " + col(
            lambda r: r["train"][route]["ms_per_step"]) + " |")
        lines.append(f"| train {route} device busy ms | " + col(
            lambda r: r["train"][route]["device_busy_ms"]) + " |")
        for kn in ("keyed_conv", "mapped_conv", "rpe_cross_attention_bwd",
                   "keyed_conv_dw", "mapped_conv_dw", "rpe_cross_attention",
                   "fps"):
            lines.append(f"| train {route} {kn} device ms/step | " + col(
                lambda r: r["train"][route]["by_kernel"][kn]["ms"]) + " |")
        for part in ("pair kernel", "dq sum", "table kernel", "table sum"):
            kp = f"rpe_cross_attention_bwd {part}"
            lines.append(f"| train {route} F {part} device ms/step | " + col(
                lambda r: r["train"][route]["by_part"][kp]["ms"]) + " |")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    parts = PARTS
    if argv[:1] == ["--only"] and len(argv) > 1:
        parts = tuple(argv[1].split(","))
        argv = argv[2:]
        if not set(parts) <= set(PARTS):
            print(f"ab_kernels: --only takes {','.join(PARTS)}",
                  file=sys.stderr)
            return 2
    if argv[:1] == ["--child"]:
        print("ab_kernels " + json.dumps(measure(parts)), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs, failed = [], False
    for tree in argv:
        tree = str(Path(tree).resolve())
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--only",
             ",".join(parts), "--child"],
            cwd=tree, env=env, capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("ab_kernels ")), None)
        if proc.returncode != 0 or line is None:
            print(f"ab_kernels: the run of {tree} failed "
                  f"(exit {proc.returncode}):\n{proc.stdout[-4000:]}")
            failed = True
            continue
        runs.append(json.loads(line[len("ab_kernels "):]))
        runs[-1]["tree"] = tree
        print(line, flush=True)
    if runs:
        print("\n".join(summary(runs)))
        print(f"card: {runs[0]['card']}")
    return 1 if failed or not all(r["ok"] for r in runs) else 0


if __name__ == "__main__":
    sys.exit(main())
