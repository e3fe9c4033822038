"""The readings that a cell's limits are set from, on the chip at the
cell's own size, many seeds in one process:

    python3 -m benchmark.calibrate --workload scannet_r34.train_b8 \\
        --seeds 11,12,13 --control 1 --faults half_batch \\
        --out build/cal.json

For each seed: the program's readings against the reference (sound
runs: the same set-up and timed path as a run; an eval cell's outputs
from a short window of `check_batches` steps); with `--control 1` the
reference computed with TF32 matmuls put in the program's place (float32
is the configurations' precision, so TF32 is the step below); with
`--faults` the faults a cell can have, planted in the reference put in
the program's place: a training step on half of each batch (the mean
over the rest, `half_batch`), the matcher's answer moved off the
matcher's (each match to the next proposal, `assign_scrambled`), an eval
answer altered where it is produced (one box moved by 5 cm,
`answer_altered`). Writes the readings as JSON after every seed. Not part
of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import check, harness, spec


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _clean(d):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


def train_seed(cell, seed, device, control, faults):
    conf, traffic = cell["config"], cell["traffic"]
    t0 = time.time()
    s = harness.set_up(cell, seed, device)
    prog, names, decisions = s.prog_read, s.names, s.decisions
    batches = [s.feed[i] for i in range(traffic["check_steps"])]
    del s
    _free(device)
    t1 = time.time()
    ref = check.reference_train(conf, traffic, seed, batches, device,
                                decisions=decisions)
    t2 = time.time()
    out = {"seed": seed, "program_s": t1 - t0, "reference_s": t2 - t1,
           "sound": _clean(check.train_readings(prog, ref, names))}
    if control:
        # the control takes its own decisions; the reference follows them
        ctl = check.reference_train(conf, traffic, seed, batches, device,
                                    tf32=True)
        judge = check.reference_train(conf, traffic, seed, batches, device,
                                      decisions=ctl["decisions"])
        out["control"] = _clean(check.train_readings(ctl, judge, names))
    if "half_batch" in faults:
        half = check.reference_train(conf, traffic, seed, batches, device,
                                     half_batch=True)
        out["half_batch"] = _clean(check.train_readings(half, ref, names))
    if "assign_scrambled" in faults:
        # the program's matches each moved to the next proposal
        moved = [dict(d, assign=[{k: v.roll(1, dims=1) for k, v in a.items()}
                                 for a in d["assign"]]) for d in decisions]
        bad = check.reference_train(conf, traffic, seed, batches, device,
                                    decisions=moved)
        out["assign_scrambled"] = _clean(check.train_readings(
            prog, bad, names))
    return out


def eval_seed(cell, seed, device, control, faults):
    from benchmark import weights as W
    from benchmark.reference import steps as R

    conf, traffic = cell["config"], cell["traffic"]
    s = harness.set_up(cell, seed, device)
    feed = s.feed
    pos = harness.eval_sample(seed, len(feed), traffic["check_batches"])
    kept = {p: {k: v.copy() for k, v in
                s.host(s.eval_step(s.trainer, feed[p])).items()} for p in pos}
    del s
    _free(device)
    out = {"seed": seed, "sound": _clean(harness.eval_check(
        cell, seed, feed, kept, device))}
    cfg, model, _ = R.build(conf, device)
    W.load(model, W.for_cell(model, conf, traffic, seed, device))
    if control:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            ctl = [{k: v.cpu().numpy() for k, v in
                    R.eval_step(cfg, model, feed[p]).items()} for p in pos]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        out["control"] = _clean(check.merge_eval(
            [check.eval_readings(conf, cfg, model, feed[p], c, device)
             for p, c in zip(pos, ctl)]))
    if "answer_altered" in faults:
        bad = {k: v.copy() for k, v in kept[pos[0]].items()}
        bad["center_unnormalized"][0, 0, 0] += 0.05
        bad["box_corners"][0, 0, :, 0] += 0.05
        out["answer_altered"] = _clean(check.merge_eval(
            [check.eval_readings(conf, cfg, model, feed[pos[0]], bad,
                                 device)]))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--faults", default="half_batch,assign_scrambled,"
                   "answer_altered", help="comma list; the cell's own apply")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path.cwd()
    cell = spec.cell(spec.load_benchmark(root), root, args.workload)
    device = torch.device("cuda")
    fn = train_seed if cell["traffic"]["step"] == "train" else eval_seed
    results = []
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.time()
        r = fn(cell, seed, device, args.control,
               [f for f in args.faults.split(",") if f])
        r["seconds"] = time.time() - t
        results.append(r)
        print(json.dumps(r, default=str)[:3000], file=sys.stderr, flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload,
             "device": torch.cuda.get_device_name(device),
             "card": harness.card_info(), "results": results}, indent=1,
            default=str))


if __name__ == "__main__":
    main()
