"""A/B of two source trees of the port on one card, in turns.

    python -m vdetr_tpu_torch.tools.ab_kernels TREE [TREE ...]

Runs the measurement below once per TREE, in the order given, each in a
child process whose working directory and import path are that tree (so
it builds and imports that tree's kernels and `chip_smoke.py`): give a
parent and a change as `parent change change parent` to compare them
within one call. A tree is a checkout of the repository, e.g. the parent
commit unpacked with `git archive` into an ignored directory. Per tree,
on the published shapes and model (`VDETRConfig()`, seeded random
weights, synthetic scenes):
- the sparse-conv kernels A (keyed) and H (mapped) and their weight
  gradients D (keyed) and I (mapped) on chip_smoke's four conv cases: ms
  per launch (CUDA events, mean of 20), the error against the plain
  version, the device ms of each kernel the call launches
  (torch.profiler, per call), and a digest of the output's bits (equal
  digests: two trees computed the same bits on the same seeded inputs);
- the RPE forward C in its eval form and its train form (dropout 0.1,
  lse and logits) on chip_smoke's decoder-shaped case: ms per launch
  (mean of 10) and the error against the plain version;
- the flash-RPE backward F at dropout 0 and 0.1: ms per launch, and its
  pair kernel, the sum of the pair kernel's key shares (a tree that has
  it) and its table kernel apart (torch.profiler, device ms per call);
- FPS, kernel B, on its main-path input (the stride-4 level's 32768
  voxel centres sampled to 4096) of one scene (B = 1) and of the four
  rows of an eval batch (B = 4): ms per launch (mean of 10) and the
  indices that differ from the plain version;
- one eval forward per route at batch 1 under torch.profiler: device ms
  and launches per port kernel;
- chip_smoke's `run_forward` (ms per scene at batch 1 and 4) and
  `run_train` (median train step, one profiled step per route, F's
  kernels apart).
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
                ("dw_sum_splits_kernel", "D/I split sums"),
                ("sum_splits_kernel", "split sums"),
                ("dw_kernel", "D/I dW GEMM"),
                ("keyed_conv_kernel", "A"),
                ("mapped_conv_kernel", "H"),
                ("map_kernel", "G"),
                ("fps_kernel", "B"),
                ("rpe_attention_kernel", "C"),
                ("rpe_pair_bwd_kernel", "F pair"),
                ("rpe_dq_sum_kernel", "F dq sum"),
                ("rpe_table_bwd_kernel", "F table"))


def _label(name: str):
    return next((lab for pat, lab in KERNEL_NAMES if pat in name), None)


def profile_by_kernel(fn, reps: int = 1):
    """{label: [device ms per call, launches per call]} of the port's
    kernels that `fn` launches (torch.profiler over `reps` warm calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        lab = _label(e.name)
        if lab is None:
            continue
        ms, n = out.get(lab, (0.0, 0))
        out[lab] = (ms + (e.time_range.end - e.time_range.start) / 1e3 / reps,
                    n + 1 / reps)
    return {k: [ms, n] for k, (ms, n) in out.items()}


def measure() -> dict:
    """The measurement of the tree in the working directory."""
    import torch

    import chip_smoke as cs
    from vdetr_tpu_torch import kernels
    from vdetr_tpu_torch.config import VDETRConfig
    from vdetr_tpu_torch.ops.rpe_attention import (
        rpe_cross_attention, rpe_cross_attention_bwd,
        rpe_cross_attention_bwd_plain, rpe_cross_attention_plain)
    from vdetr_tpu_torch.ops.sparse_conv_kernel import (
        mapped_conv, mapped_conv_dw, mapped_conv_dw_plain, mapped_conv_plain)
    from vdetr_tpu_torch.ops.sparse_conv_keyed import (
        keyed_conv, keyed_conv_dw, keyed_conv_dw_plain, keyed_conv_plain)
    from vdetr_tpu_torch.tools import card, time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.build_all()
    smi = card()
    res = {"tree": os.getcwd(), "card": smi, "conv": {}, "rpe_fwd": {},
           "rpe_bwd": {}}
    cfg = VDETRConfig()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    grids = cs.level_grids(cfg, dev)
    for case in cs.conv_cases(cfg, grids, gen):
        label, args, dout, nbr = case[0], case[1], case[2], case[4]
        row = {}
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
            row[name] = {"ms": time_ms(lambda: fn(*a), reps=20),
                         "max_abs_err": err,
                         "sha256": hashlib.sha256(
                             got.cpu().numpy().tobytes()).hexdigest()[:16],
                         "max_ref": float(ref.abs().max()),
                         "parts": profile_by_kernel(lambda: fn(*a), reps=5)}
        res["conv"][label] = row
    del grids
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
        got, ref = (x[0] if isinstance(x, tuple) else x for x in (got, ref))
        res["rpe_fwd"][form] = {
            "ms": time_ms(lambda: rpe_cross_attention(*case, **ckw), reps=10),
            "max_abs_err": float((got - ref).abs().max())}
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
        ref = rpe_cross_attention_bwd_plain(*a, **fkw)
        errs = {n: float((g - r).abs().max()) for n, g, r in
                zip(("dq", "dtables", "ds", "eg"), got, ref)}
        res["rpe_bwd"][str(rate)] = {
            "ms": time_ms(lambda: rpe_cross_attention_bwd(*a, **fkw),
                          reps=10),
            "parts": profile_by_kernel(
                lambda: rpe_cross_attention_bwd(*a, **fkw), reps=5),
            "max_abs_err": errs}
        del got, ref, out, lse, logits
    del case, dout
    res["fps"] = measure_fps(cfg, dev, cs)
    torch.cuda.empty_cache()

    models = {r: cs.published_model(cfg, dev, r) for r in cs.ROUTES}
    inputs = cs.synthetic_batch(cfg.num_points, 1, dev)
    with torch.inference_mode():
        res["forward_profile"] = {
            r: profile_by_kernel(lambda: m(inputs)) for r, m in models.items()}
    ok_f, _, per_scene = cs.run_forward(models, cfg, dev, smi)
    del models
    torch.cuda.empty_cache()
    ok_t, _, train = cs.run_train(cfg.replace(matcher_impl="jv"), dev, smi)
    res["forward_ms_per_scene"] = {
        r: {str(b): t for b, t in v.items()} for r, v in per_scene.items()}
    res["ok"] = bool(ok_f and ok_t)
    res["train"] = {
        r: {"ms_per_step": train[r]["ms_per_step"],
            "steps": train[r]["steps"],
            "device_busy_ms": train[r]["profile"]["device_busy_ms"],
            "busy_share": train[r]["profile"]["busy_share"],
            "by_kernel": train[r]["profile"]["by_kernel"],
            "by_part": train[r]["profile"]["by_part"]}
        for r in cs.ROUTES}
    return res


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
    for label in runs[0]["conv"]:
        for k in ("A", "H", "D", "I"):
            lines.append(f"| {k} ms {label} | "
                         + col(lambda r: r["conv"][label][k]["ms"]) + " |")
            parts = sorted({p for r in runs
                            for p in r["conv"][label][k]["parts"]})
            for part in parts:
                lines.append(f"| {k} {label}: {part} device ms | " + col(
                    lambda r: r["conv"][label][k]["parts"][part][0]) + " |")
    for label in runs[0]["conv"]:
        for k in ("A", "H", "D", "I"):
            lines.append(f"| {k} output sha256 {label} | " + " | ".join(
                r["conv"][label][k].get("sha256", "-") for r in runs) + " |")
    for form in ("eval", "train"):
        lines.append(f"| C ms {form} form | "
                     + col(lambda r: r["rpe_fwd"][form]["ms"]) + " |")
    for rate in ("0.0", "0.1"):
        lines.append(f"| F ms dropout {rate} | "
                     + col(lambda r: r["rpe_bwd"][rate]["ms"]) + " |")
        for part in ("F pair", "F dq sum", "F table"):
            lines.append(f"| {part} device ms dropout {rate} | " + col(
                lambda r: r["rpe_bwd"][rate]["parts"][part][0]) + " |")
    for batch in ("1", "4"):
        lines.append(f"| B ms B={batch} | "
                     + col(lambda r: r["fps"][batch]["ms"]) + " |")
        lines.append(f"| B indices differing B={batch} | "
                     + col(lambda r: r["fps"][batch]["mismatches"]) + " |")
    for route in ("keyed", "mapped"):
        for lab in ("A", "H", "C", "B", "G"):  # C: one launch per layer
            lines.append(f"| forward {route} B=1 {lab} device ms | " + col(
                lambda r: r["forward_profile"][route][lab][0]) + " |")
        for b in (1, 4):
            lines.append(f"| forward {route} ms/scene B={b} | " + col(
                lambda r: r["forward_ms_per_scene"][route][str(b)]) + " |")
        lines.append(f"| train {route} median step ms | " + col(
            lambda r: r["train"][route]["ms_per_step"]) + " |")
        lines.append(f"| train {route} device busy ms | " + col(
            lambda r: r["train"][route]["device_busy_ms"]) + " |")
        for kn in ("keyed_conv", "mapped_conv", "rpe_cross_attention_bwd",
                   "keyed_conv_dw", "mapped_conv_dw", "rpe_cross_attention",
                   "fps"):
            lines.append(f"| train {route} {kn} device ms/step | " + col(
                lambda r: r["train"][route]["by_kernel"][kn]["ms"]) + " |")
        for part in ("pair kernel", "dq sum", "table kernel"):
            kp = f"rpe_cross_attention_bwd {part}"
            lines.append(f"| train {route} F {part} device ms/step | " + col(
                lambda r: r["train"][route]["by_part"][kp]["ms"]) + " |")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        print("ab_kernels " + json.dumps(measure()), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs, failed = [], False
    for tree in argv:
        tree = str(Path(tree).resolve())
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child"],
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
