"""One run of one cell: set-up, the measured window, the traced steps,
the check against the reference, and the result line.

A run is a closed loop of one client: the program's step back to back
on batches that cycle through the traffic's pool of scenes, until
`seconds` have passed; every step started in the window is finished and
counted, and the window's time runs to the end of the last one. The
train step ends when its loss is on the host (`Trainer.train_step` reads
it); the eval step when its outputs are on the host, where the AP
calculator reads them.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from benchmark import check, scenes
from benchmark import trace as T

FORBIDDEN = ("jax", "jaxlib", "flax", "vdetr_tpu")
ADAM_BETA1 = 0.9


def process_start_time() -> float:
    """The wall-clock time this process started, from /proc."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (compared whole: `vdetr_tpu_torch` is not
    `vdetr_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Feed:
    """The batches of a run on the device, in the order `--seed` gives."""

    def __init__(self, cell: dict, seed: int, device):
        traffic, conf = cell["traffic"], cell["config"]
        pool = scenes.scene_pool(traffic, conf["dataset_config"])
        self.order = scenes.batch_order(len(pool), traffic["batch"], seed)
        self.batches = [
            {k: torch.from_numpy(v).to(device)
             for k, v in scenes.collate(pool, idx).items()}
            for idx in self.order]

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, i):
        return self.batches[i % len(self.batches)]


class HostCopy:
    """The eval step's outputs copied to pinned host buffers, one copy
    each and one synchronization."""

    def __init__(self):
        self.bufs: Dict[str, torch.Tensor] = {}

    def __call__(self, out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        dev = next(iter(out.values())).device
        for k, v in out.items():
            if k not in self.bufs:
                self.bufs[k] = torch.empty(v.shape, dtype=v.dtype,
                                           pin_memory=dev.type == "cuda")
            self.bufs[k].copy_(v, non_blocking=True)
        _sync(dev)
        return {k: b.numpy() for k, b in self.bufs.items()}


class Setup(SimpleNamespace):
    """A cell's program after set-up: `trainer`, `feed`, the dropout
    `gen`, the timed path's `train_step` / `eval_step`, `host` (the
    outputs' copy), the parameter `names`, the next batch `pos`, and for
    training `prog_read`, the readings of its first steps, and
    `decisions`, their choices of proposals and assignments."""


def set_up(cell: dict, seed: int, device, hooks: dict = None) -> Setup:
    """Build the program's trainer with the run's weights and feed, and
    drive it through its first steps: a training cell's `check_steps`
    (recording their losses, the first gradient as AdamW got it, and the
    parameters' change), an eval cell's two warm steps."""
    from benchmark import program

    hooks = hooks or {}
    traffic, conf = cell["traffic"], cell["config"]
    if device.type == "cuda":
        from vdetr_tpu_torch import kernels
        kernels.build_all()
    s = Setup(feed=Feed(cell, seed, device), host=HostCopy(), pos=0,
              prog_read=None, decisions=[],
              gen=check.dropout_generator(seed, device),
              train_step=hooks.get("train_step",
                                   lambda tr, b, g: tr.train_step(b, g)),
              eval_step=hooks.get("eval_step", lambda tr, b: tr.eval_step(b)))
    s.trainer, w0 = program.build_trainer(conf, traffic, seed, device)
    s.names = [n for n, p in s.trainer.model.named_parameters()
               if p.requires_grad]
    if traffic["step"] == "train":
        losses = []
        for i in range(traffic["check_steps"]):
            with program.record_decisions(
                    s.trainer.model,
                    conf["dataset_config"]["mean_size_arr"]) as rec:
                rec.append({})
                loss, _ = s.train_step(s.trainer, s.feed[s.pos], s.gen)
            s.decisions.append(rec[0])
            losses.append(loss)
            s.pos += 1
            if i == 0:
                params = dict(s.trainer.model.named_parameters())
                state = s.trainer.optimizer.state
                grad = {n: state[params[n]]["exp_avg"] / (1 - ADAM_BETA1)
                        if params[n] in state else torch.zeros_like(
                            params[n]) for n in s.names}
                grad_norms = check.leaf_norms(grad, s.names)
                del grad
        params = dict(s.trainer.model.named_parameters())
        delta_norms = check.leaf_norms(
            {n: params[n].detach() - w0[n] for n in s.names}, s.names)
        s.prog_read = {"losses": losses, "grad": grad_norms,
                       "delta": delta_norms}
    else:
        for _ in range(2):  # the shapes of the window, warmed
            s.host(s.eval_step(s.trainer, s.feed[s.pos]))
            s.pos += 1
    return s


def execute(cell: dict, seed: int, seconds: float, traced: bool, device,
            limits: Dict[str, float], readers: Dict[str, Callable] = None,
            t_start: Optional[float] = None, trace_dir: Path = None,
            hooks: dict = None) -> dict:
    """Run `cell` ({"entry", "config", "traffic"}) once; returns the
    result line's dict. `hooks` (tests only) replace parts of the timed
    path: "train_step" (trainer, batch, gen) and "eval_step" (trainer,
    batch) -> the program's outputs."""
    device = torch.device(device)
    t_start = time.time() if t_start is None else t_start
    traffic, conf = cell["traffic"], cell["config"]
    train = traffic["step"] == "train"
    s = set_up(cell, seed, device, hooks)
    trainer, feed, gen, host = s.trainer, s.feed, s.gen, s.host
    train_step, eval_step, names, pos = (s.train_step, s.eval_step, s.names,
                                         s.pos)
    prog_read, decisions = s.prog_read, s.decisions
    del s
    work = None
    if traced:
        from benchmark import flops
        from benchmark.reference.config import ref_config
        rcfg = ref_config(conf)
        work = [flops.step_work(rcfg, feed[i], train)
                for i in range(len(feed))]
    _sync(device)
    setup_s = time.time() - t_start

    # ---- the measured window ----
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    window_pos, lat, kept = [], [], {}
    sample = [] if train else eval_sample(seed, len(feed),
                                          traffic["check_batches"])
    t_open = time.perf_counter()
    deadline = t_open + seconds
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        if train:
            train_step(trainer, feed[pos], gen)
        else:
            out = host(eval_step(trainer, feed[pos]))
        _sync(device)
        lat.append(time.perf_counter() - t0)
        p = pos % len(feed)
        if p in sample and p not in kept:
            kept[p] = {k: v.copy() for k, v in out.items()}
        window_pos.append(p)
        pos += 1
    window_s = time.perf_counter() - t_open
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # ---- the traced steps: without the Python tracer (the device's busy
    # and idle time, the host's), then with it (each launch's layer) ----
    tr = tr_stack = None
    if traced:
        def step(i):
            if train:
                train_step(trainer, feed[i], gen)
            else:
                host(eval_step(trainer, feed[i]))

        layers = {}
        for fn in (readers or {}).values():
            layers.update(getattr(fn, "LAYER_FILES", {}))
        tr, traced_pos, pos = profiled_steps(
            step, pos, len(feed), traffic["trace_steps"], device,
            trace_dir / "benchmark_trace.json", {}, stack=False)
        tr_stack, stack_pos, pos = profiled_steps(
            step, pos, len(feed), traffic["trace_steps"], device,
            trace_dir / "benchmark_trace_stack.json", layers,
            stack=True)
    peak = max(setup_peak, window_peak)

    # ---- the check, the program's state freed first ----
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if train:
        ref = check.reference_train(
            conf, traffic, seed, [feed[i] for i in
                                  range(traffic["check_steps"])], device,
            decisions=decisions)
        readings = check.train_readings(prog_read, ref, names)
    else:
        readings = eval_check(cell, seed, feed, kept, device)
    correct, checks = check.judge(readings, limits)
    notes = {k: v for k, v in readings.items() if k not in checks}

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: "
                         f"{bad}")

    B = traffic["batch"]
    result = {"correct": bool(correct), "attempted": len(lat), "failed": 0}
    if traced:
        ctx = SimpleNamespace(kind="train" if train else "eval", trace=tr,
                              stack_trace=tr_stack, work=work,
                              window_s=window_s, window_pos=window_pos,
                              traced_pos=traced_pos, stack_pos=stack_pos,
                              batch=B, dtype=conf["model"]["compute_dtype"])
        metrics = {}
        for name, fn in (readers or {}).items():
            v = fn(ctx)
            if v is not None:
                metrics[name] = {"value": v[0], "unit": v[1]}
        result["metrics"] = metrics
    else:
        result["metrics"] = end_to_end(train, B, lat, window_s, window_peak,
                                       setup_s)
    result["device"] = device_info(device, peak, tr)
    if tr is not None:
        result["breakdown"] = {
            "device_ops": [[n, us / 1e6] for n, us in tr.top_ops()],
            "idle_gaps": [[n, us / 1e6] for n, us in tr.idle_gaps()]}
    result["card"] = card_info() if cuda else None
    result["notes"] = notes
    result["checks"] = checks
    return result


def profiled_steps(step, pos, n_batches, n_steps, device, path, layers,
                   stack):
    """`n_steps` steps from batch `pos` under `torch.profiler` (CPU and,
    on the card, CUDA activity; `stack`: the Python tracer too), each in a
    `benchmark.step` span; the trace exported to `path` and read.
    Returns (trace, the steps' batches, the next batch)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    done = []
    with profile(activities=acts, with_stack=stack) as prof:
        for _ in range(n_steps):
            with record_function(T.STEP_SPAN):
                step(pos)
                _sync(device)
            done.append(pos % n_batches)
            pos += 1
    prof.export_chrome_trace(str(path))
    return T.load(str(path), layers), done, pos


def eval_sample(seed: int, n_batches: int, k: int):
    """The `k` batches of the feed, drawn from the seed, whose first
    answers in the window are judged."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC4EC]))
    return sorted(int(p) for p in rng.choice(n_batches, k, replace=False))


def eval_check(cell, seed, feed, kept, device) -> dict:
    """The eval numbers of the window's sampled answers `kept` ({batch:
    the program's outputs}), every one of them due: a sampled batch the
    window never reached reads inf."""
    from benchmark import weights as W
    from benchmark.reference import steps as R

    conf, traffic = cell["config"], cell["traffic"]
    cfg, model, _ = R.build(conf, device)
    W.load(model, W.for_cell(model, conf, traffic, seed, device))
    parts = [check.eval_readings(conf, cfg, model, feed[p], kept[p], device)
             if p in kept else check.unreadable_eval()
             for p in eval_sample(seed, len(feed), traffic["check_batches"])]
    return check.merge_eval(parts)


def end_to_end(train, B, lat, window_s, window_peak, setup_s) -> dict:
    m = {}
    rate = B * len(lat) / window_s
    if train:
        m["train_scenes_per_s"] = {"value": rate, "unit": "scenes/s"}
    else:
        m["eval_scenes_per_s"] = {"value": rate, "unit": "scenes/s"}
        q = np.quantile(np.asarray(lat) * 1e3, 0.9, method="linear")
        m["eval_step_p90_ms"] = {"value": float(q), "unit": "ms"}
    m["peak_mem_gib"] = {"value": window_peak / 2 ** 30, "unit": "GiB"}
    m["setup_s"] = {"value": setup_s, "unit": "s"}
    return m


def device_info(device, peak, tr) -> dict:
    if device.type == "cuda":
        d = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
             "count": 1, "memory_peak_bytes": int(peak)}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": 1,
             "memory_peak_bytes": 0}
    if tr is not None:
        d["busy_s"] = tr.busy_us / 1e6
        d["window_s"] = tr.window_us / 1e6
    return d


def card_info():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or None
