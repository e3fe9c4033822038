"""Data-parallel train steps in spawned ranks, for `chip_smoke.py`'s
phase 9 and the CPU tests (`tests/test_torch_parallel.py`), and where a
data-parallel step's time goes:

    python -m vdetr_tpu_torch.tools.dp_step [--steps 8]

runs, on the card at world size 1 on NCCL, the published train step
(`VDETRConfig()`, keyed, batch 1, the auction, dropout on) as the plain
`Trainer`, with DDP alone (`mink_syncbn=False`), with sync-BN alone (the
norms' and the criterion's all-reduces, no DDP) and with both, from one
state, in turns on the same scenes; prints each variant's median host
ms (the first two steps dropped) and, for the plain step and both, one
step's host ops by self CPU time under torch.profiler, then the card.

`train_rank(rank, spec)` is one rank of a group that takes
`Trainer.train_step`s on its rows of global batches (and, under key
sharding, its block of their points: `chip_smoke.py` phase 11) and
returns what it saw: each step's loss, loss dict, host ms, launches per
kernel and peak memory, then its gradients, parameters and buffers, and
optionally the eval steps before them, the same steps again from the
same state, and the collectives of one more step under torch.profiler. `plain_vs_world1` is
the one rank of a world of 1 that holds the data-parallel step to the
plain one in the same process. Run either with
`vdetr_tpu_torch.tools.run_ranks`, which spawns the ranks under a time
limit.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch


def _setup(rank: int, spec: dict):
    """(device, group) of a spawned rank: its torch threads, TF32 off on
    the card, the group joined."""
    from vdetr_tpu_torch.parallel import dist

    if spec.get("threads"):
        torch.set_num_threads(spec["threads"])
    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    group = dist.init(rank, spec["world"], spec["init_method"],
                      spec["backend"], timeout=spec["timeout"])
    return device, group


def _model(spec: dict, device):
    from vdetr_tpu_torch.data.dataset_config import get_dataset_config
    from vdetr_tpu_torch.models.vdetr import build_model

    cfg = spec["cfg"]
    model = build_model(cfg, get_dataset_config(cfg.dataset_name),
                        generator=torch.Generator().manual_seed(
                            spec.get("weights_seed", 0)),
                        device=device, conv_route=spec.get("route", "keyed"))
    if spec.get("state"):
        model.load_state_dict(torch.load(spec["state"], weights_only=True))
    return model


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_step(trainer, batch, gen, counters=None):
    """One train step: (loss, loss dict as floats, host ms ending in a
    sync, launches per kernel, peak GiB on the card)."""
    dev = trainer.device
    for fn in (counters or {}).values():
        fn.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    loss, parts = trainer.train_step(batch, gen)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else 0.0)
    return (loss, {k: float(v) for k, v in parts.items()}, ms,
            {k: fn.launches for k, fn in (counters or {}).items()}, peak)


def timed_eval(trainer, batch, counters=None):
    """One eval step: (whether every output is finite, host ms ending in
    a sync, launches per kernel, peak GiB on the card, boxes kept)."""
    dev = trainer.device
    for fn in (counters or {}).values():
        fn.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    out = trainer.eval_step(batch)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else 0.0)
    finite = all(bool(torch.isfinite(v).all()) for v in out.values()
                 if v.is_floating_point())
    kept = int(out["nms_keep"].sum()) if "nms_keep" in out else -1
    return (finite, ms, {k: fn.launches for k, fn in (counters or {}).items()},
            peak, kept)


def collectives(trainer, batch, gen) -> dict:
    """One train step under torch.profiler: the collectives it ran (the
    process group's host events, "nccl:*" or "gloo:*", by name) and the
    device ms of NCCL's kernels; their host ms summed."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        trainer.train_step(batch, gen)
        _sync(trainer.device)
    by_name, host_us, dev_us, dev_n = {}, 0.0, 0.0, 0
    for e in prof.events():
        if e.name.startswith(("nccl:", "gloo:")):
            by_name[e.name] = by_name.get(e.name, 0) + 1
            host_us += e.time_range.elapsed_us()
        elif (getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA
              and "nccl" in e.name.lower()):
            dev_n += 1
            dev_us += e.time_range.elapsed_us()
    return {"count": sum(by_name.values()), "by_name": by_name,
            "host_ms": host_us / 1e3, "device_kernels": dev_n,
            "device_ms": dev_us / 1e3}


def _state(model) -> dict:
    return {"grads": {n: p.grad.detach().cpu().clone()
                      for n, p in model.named_parameters()},
            "params": {n: p.detach().cpu().clone()
                       for n, p in model.named_parameters()},
            "buffers": {n: b.detach().cpu().clone()
                        for n, b in model.named_buffers()}}


def train_rank(rank: int, spec: dict) -> dict:
    """One rank of `spec["world"]` (`init_method`, `backend`, `device`,
    `timeout`, optional `threads`): the model of `spec["cfg"]` on
    `route` from `weights_seed`, or from the state_dict at `state`; a
    step on its rows of each global batch of `batches` (numpy dicts),
    dropout from the rank's `epoch_generator` of epoch 0; with `profile`,
    one more step (on the last batch) under torch.profiler, after the
    state is taken. The ranks form the grid of `cfg`'s mesh: rank (d, s)
    steps on data rank d's rows and point block s. `eval_cfg` and
    `eval_batches`: first an eval step of `eval_cfg`'s trainer on each,
    from the same weights; `repeat`: then the same steps again with a new
    trainer from the same weights, and whether they left every parameter
    and buffer the same bits. Returns {"steps": [(loss, loss dict, ms,
    launches, peak GiB)], "grads", "params", "buffers" (after the steps,
    on the CPU), "eval": [`timed_eval`], "repeat_differs": [names],
    "collectives"}."""
    from vdetr_tpu_torch.data.dataset_config import get_dataset_config
    from vdetr_tpu_torch.data.loader import seq_block
    from vdetr_tpu_torch.parallel import dist
    from vdetr_tpu_torch.tools import launch_counters
    from vdetr_tpu_torch.train.engine import Trainer, epoch_generator

    device, group = _setup(rank, spec)
    try:
        cfg = spec["cfg"]
        ds = get_dataset_config(cfg.dataset_name)

        def trainer_of(c):
            return Trainer(c, _model(spec, device), ds,
                           steps_per_epoch=spec.get("steps_per_epoch", 1),
                           device=device, group=group)

        trainer = trainer_of(cfg)
        g = trainer.grid

        def mine(b):
            rows = dist.rows(len(b["point_clouds"]), g.d, g.D)
            return seq_block({k: v[rows] for k, v in b.items()}, g.s, g.S)

        counters = launch_counters()
        out = {}
        if spec.get("eval_batches"):
            ev = trainer_of(spec["eval_cfg"])
            out["eval"] = [timed_eval(ev, mine(b), counters)
                           for b in spec["eval_batches"]]
            del ev
        mine_b = [mine(b) for b in spec["batches"]]
        gen = epoch_generator(trainer, 0)
        out["steps"] = [timed_step(trainer, b, gen, counters)
                        for b in mine_b]
        out.update(_state(trainer.model))
        if spec.get("repeat"):
            again = trainer_of(cfg)
            gen = epoch_generator(again, 0)
            for b in mine_b:
                again.train_step(b, gen)
            twin = dict(again.model.state_dict())
            out["repeat_differs"] = [
                n for n, v in trainer.model.state_dict().items()
                if not torch.equal(v, twin[n])]
            del again
        if spec.get("profile"):
            out["collectives"] = collectives(trainer, mine_b[-1], gen)
        dist.barrier(group)
        return out
    finally:
        dist.destroy(group)


def plain_vs_world1(rank: int, spec: dict) -> dict:
    """The one rank of a world of 1 (`spec` as `train_rank`'s): the plain
    `Trainer` and the data-parallel one (DDP, sync-BN, the criterion's and
    the loss's all-reduces over the group) from the same weights, two
    steps each on `batches[0]` and `batches[1]` (dropout from each one's
    epoch generator, the same seed at rank 0), then their parameters,
    buffers, losses and launches compared bit for bit; then a step of
    each on every later batch, in turns, timed; then one step of each
    under torch.profiler, its collectives counted."""
    from vdetr_tpu_torch.data.dataset_config import get_dataset_config
    from vdetr_tpu_torch.tools import launch_counters
    from vdetr_tpu_torch.train.engine import Trainer, epoch_generator

    device, group = _setup(rank, spec)
    try:
        cfg, batches = spec["cfg"], spec["batches"]
        ds = get_dataset_config(cfg.dataset_name)
        trainers = {"plain": Trainer(cfg, _model(spec, device), ds, 1000,
                                     device=device),
                    "data parallel": Trainer(cfg, _model(spec, device), ds,
                                             1000, device=device,
                                             group=group)}
        gens = {k: epoch_generator(t, 0) for k, t in trainers.items()}
        counters = launch_counters()
        steps = {k: [timed_step(t, b, gens[k], counters)
                     for b in batches[:2]] for k, t in trainers.items()}
        plain, dp = (dict(trainers[k].model.state_dict())
                     for k in ("plain", "data parallel"))
        differ = [n for n, v in plain.items() if not torch.equal(v, dp[n])]
        times = {k: [] for k in trainers}
        for i, b in enumerate(batches[2:]):
            for k in (list(trainers) if i % 2 == 0
                      else list(trainers)[::-1]):
                times[k].append(timed_step(trainers[k], b, gens[k])[2])
        return {
            "steps": steps, "state_differs": differ,
            "state_compared": len(plain),
            "losses_equal": all(a[0] == b[0] for a, b in zip(
                steps["plain"], steps["data parallel"])),
            "launches_equal": all(a[3] == b[3] for a, b in zip(
                steps["plain"], steps["data parallel"])),
            "ms": times,
            "median_ms": {k: statistics.median(v) for k, v in times.items()},
            "collectives": {k: collectives(t, batches[-1], gens[k])
                            for k, t in trainers.items()}}
    finally:
        from vdetr_tpu_torch.parallel import dist

        dist.destroy(group)


def variants_world1(rank: int, spec: dict) -> dict:
    """The one rank of a world of 1 (`spec` as `train_rank`'s): the plain
    step, DDP alone, sync-BN alone and both, from one state, in turns on
    `batches`; then one profiled step of the plain and of both. Returns
    {"ms": {variant: [ms]}, "tables": {variant: profiler table}}."""
    from torch.profiler import ProfilerActivity, profile

    from vdetr_tpu_torch.data.dataset_config import get_dataset_config
    from vdetr_tpu_torch.models.norm import sync_batch_norms
    from vdetr_tpu_torch.parallel import dist
    from vdetr_tpu_torch.train.engine import Trainer, epoch_generator

    device, group = _setup(rank, spec)
    try:
        cfg, batches = spec["cfg"], spec["batches"]
        ds = get_dataset_config(cfg.dataset_name)

        def trainer(c, g=None):
            return Trainer(c, _model(spec, device), ds, 1000, device=device,
                           group=g)

        trainers = {"plain": trainer(cfg),
                    "DDP alone": trainer(cfg.replace(mink_syncbn=False),
                                         group),
                    "sync-BN alone": trainer(cfg),
                    "both": trainer(cfg, group)}
        sync_batch_norms(trainers["sync-BN alone"].model, group)
        trainers["sync-BN alone"].criterion.group = group
        gens = {k: epoch_generator(t, 0) for k, t in trainers.items()}
        names = list(trainers)
        ms = {k: [] for k in names}
        for i, b in enumerate(batches):
            for k in (names if i % 2 == 0 else names[::-1]):
                ms[k].append(timed_step(trainers[k], b, gens[k])[2])
        tables = {}
        for k in ("plain", "both"):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                timed_step(trainers[k], batches[-1], gens[k])
            tables[k] = prof.key_averages().table(
                sort_by="self_cpu_time_total", row_limit=20)
        return {"ms": ms, "tables": tables}
    finally:
        dist.destroy(group)


def main(argv=None) -> int:
    import datetime
    import tempfile

    from vdetr_tpu_torch import kernels
    from vdetr_tpu_torch.config import VDETRConfig
    from vdetr_tpu_torch.data.dataset_config import get_dataset_config
    from vdetr_tpu_torch.data.synthetic import (SyntheticDetectionDataset,
                                                collate)
    from vdetr_tpu_torch.tools import card, run_ranks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dp_step: no CUDA device")
    kernels.build_all()
    cfg = VDETRConfig()
    data = SyntheticDetectionDataset(get_dataset_config(cfg.dataset_name),
                                     cfg.num_points, seed=0)
    batches = [collate([data[i]]) for i in range(args.steps)]
    with tempfile.TemporaryDirectory() as tmp:
        res = run_ranks(variants_world1, 1, dict(
            world=1, init_method=f"file://{tmp}/rdzv", backend="nccl",
            device="cuda:0", cfg=cfg, batches=batches, weights_seed=0,
            timeout=datetime.timedelta(seconds=300)), 900)[0]
    for k, v in res["ms"].items():
        print(f"{k}: median {statistics.median(v[2:]):.1f} ms over "
              f"{len(v) - 2} steps after 2 [" + ", ".join(
                  f"{t:.1f}" for t in v) + "]")
    for k, table in res["tables"].items():
        print(f"{k}: one step's host ops by self CPU time\n{table}")
    print(f"card: {card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
