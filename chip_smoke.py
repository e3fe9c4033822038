#!/usr/bin/env python3
"""Smoke test of the PyTorch port (vdetr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit;
  2. build: compiles the CUDA kernels of vdetr_tpu_torch/csrc for sm_90a;
  3. kernels: each kernel's wrapper against its plain PyTorch version on
     the card, at the shapes the published model's forward gives it,
     with TF32 off; prints the error, its tolerance, and both times;
  4. forward: the published VDETR (VDETRConfig() defaults, seeded random
     weights) on synthetic 100k-point scenes at batch 1 and 4 under
     torch.inference_mode(): outputs finite and of the expected shapes,
     every kernel launched the expected number of times, median ms per
     scene and peak memory; and a small model whose kernel forward on
     the card agrees with the plain forward on the CPU;
  5. a JSON line of per-kernel results, then the last line
     {"ok": true, "device": {...}} -- printed only when every phase
     passed.

Exits non-zero without printing a result when CUDA is unavailable, or
when any phase fails. Imports no jax.
"""

from __future__ import annotations

import json
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
}


def log(*args):
    print(*args, flush=True)


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


def check_keyed_conv(cfg, grids, gen):
    from vdetr_tpu_torch.ops.sparse_conv_keyed import (keyed_conv,
                                                       keyed_conv_plain)

    device = grids[0].keys.device
    w = cfg.inplanes
    # (input level, output level, C_in, C_out): the stem, a stage-1
    # submanifold conv, a stride-2 conv into stage 2, a stage-4 conv
    cases = [(0, 1, 3, w), (2, 2, w, w), (2, 3, w, 2 * w),
             (5, 5, 8 * w, 8 * w)]
    errs, ms, plain_ms, out_cases = [], 0.0, 0.0, []
    for li, lo, cin, cout in cases:
        gi, go = grids[li], grids[lo]
        feats = torch.randn(gi.keys.shape + (cin,), generator=gen,
                            device=device) * gi.valid[..., None]
        wt = torch.randn(27, cin, cout, generator=gen, device=device)
        wt = wt * (2.0 / (27 * cin)) ** 0.5
        q = go.coords if li == lo else go.coords * 2
        args = (feats.contiguous(), gi.keys, q.contiguous(), go.valid,
                gi.extent, wt)
        got = keyed_conv(*args)
        ref = keyed_conv_plain(*args)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        tol = 1e-4 * max(1.0, scale)
        t_k = time_ms(lambda: keyed_conv(*args), reps=10)
        t_p = time_ms(lambda: keyed_conv_plain(*args), reps=3)
        nvalid = int(go.valid.sum())
        label = (f"{cin}->{cout} {'submanifold' if li == lo else 'stride-2'}"
                 f" V_in={gi.capacity} V={go.capacity} valid={nvalid}")
        ok = err <= tol
        log(f"check keyed_conv {label}: max_abs_err={err:.3e} "
            f"(max|ref|={scale:.3e}) tol={tol:.3e} -> {'ok' if ok else 'FAIL'};"
            f" kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
        errs.append((err, ok))
        ms += t_k
        plain_ms += t_p
        out_cases.append({"case": label, "max_abs_err": err, "ms": t_k,
                          "plain_ms": t_p})
    log("  tolerance reason: float32 sums of up to 27*C_in products taken in "
        "another order than the plain per-offset matmuls; 1e-4 of max|ref| "
        "is ~10x the sqrt(n)*2^-24 rounding spread at n = 27*512")
    return (all(ok for _, ok in errs), max(e for e, _ in errs), ms, plain_ms,
            out_cases)


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
    log(f"check fps N={xyz.shape[1]} (valid={int(out_level.valid.sum())}) "
        f"npoint={cfg.preenc_npoints}: {mism} indices differ, tolerance 0 "
        f"(both round fma(dz,dz,fma(dy,dy,dx*dx)) exactly) -> "
        f"{'ok' if ok else 'FAIL'}; kernel {t_k:.3f} ms, plain {t_p:.1f} ms"
        f" (one timed call)")
    return ok, err, t_k, t_p


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
    return ok_all, max(errs), t_k, t_p


# --------------------------------------------------------------------------
# phase 4: the published forward
# --------------------------------------------------------------------------

def expected_launches(model, cfg):
    from vdetr_tpu_torch.models.backbone import SparseConv, SparseConvDown

    convs = sum(1 for m in model.modules()
                if isinstance(m, (SparseConv, SparseConvDown))
                and m.kernel_size == 3)
    return {"keyed_conv": convs, "fps": 1,
            "rpe_cross_attention": cfg.dec_nlayers - 1}


def launch_counters():
    from vdetr_tpu_torch.ops.fps import furthest_point_sample
    from vdetr_tpu_torch.ops.rpe_attention import rpe_cross_attention
    from vdetr_tpu_torch.ops.sparse_conv_keyed import keyed_conv

    return {"keyed_conv": keyed_conv, "fps": furthest_point_sample,
            "rpe_cross_attention": rpe_cross_attention}


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
    model = build_model(cfg, ds, generator=gen).to(device)
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
    model = build_model(cfg, ScannetDatasetConfig(), generator=gen)
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
    ok_a, err_a, ms_a, pms_a, cases_a = check_keyed_conv(cfg, grids, gen)
    ok_b, err_b, ms_b, pms_b = check_fps(cfg, grids)
    ok_c, err_c, ms_c, pms_c = check_rpe(cfg, device, gen)

    # 4. the published forward, then a small one against the CPU
    ok_f, launches, per_scene = run_forward(
        cfg, device, torch.Generator().manual_seed(SEED), smi)
    ok_s = check_small_forward_against_cpu(
        device, torch.Generator().manual_seed(SEED + 1))

    results = [("keyed_conv", err_a, ms_a, pms_a),
               ("fps", err_b, ms_b, pms_b),
               ("rpe_cross_attention", err_c, ms_c, pms_c)]
    record = {"kernels": []}
    for kname, err, ms, pms in results:
        src, repl = REPO_SOURCES[kname]
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": repl, "launches": launches[kname],
                 "max_abs_err": err, "ms": ms, "plain_ms": pms}
        if kname == "keyed_conv":
            entry["cases"] = cases_a
        record["kernels"].append(entry)
    record["forward_ms_per_scene"] = {f"B={b}": t for b, t in
                                      per_scene.items()}
    record["card"] = smi
    log(json.dumps(record))
    if not (ok_a and ok_b and ok_c and ok_f and ok_s):
        log("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
