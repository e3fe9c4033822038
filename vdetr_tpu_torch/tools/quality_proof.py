"""The synthetic-overfit quality proof of the port (counterpart of the
JAX package's `tools/quality_proof.py`).

    python -m vdetr_tpu_torch.tools.quality_proof [--steps 3000]
        [--scenes 32] [--batch 1] [--lr 5e-4] [--warmup_steps 200]
        [--eval_every 500] [--max_objects 10] [--out PATH] [--jsonl PATH]
        [--seed 0] [--tiny] [--device cuda|cpu]

Trains the model on a FIXED set of synthetic scenes (`data/synthetic.py`)
and, every `--eval_every` steps and at the end, runs the complete eval
pipeline over the same scenes: `Trainer.eval_step` (forward, sigmoid,
device NMS on kernel N) and the VoteNet AP (`eval/ap_calculator.py`,
`eval/eval_det.py`). mAP@0.25 near 100 on the training scenes shows that
the model, matcher, criterion, NMS and AP protocol agree end to end.

The protocol is the JAX tool's: up to `--max_objects` objects a scene,
AdamW at `--lr` with `--warmup_steps` of linear warm-up and a cosine to
`lr / 20`, the eval config of the training loop (`test_only` off, so no
empty-box removal). The matcher is `VDETRConfig()`'s, the capacity
auction (kernel M on the card), as in the JAX tool's runs. The model is
the published one (`VDETRConfig()`), or with `--tiny` the JAX tool's
reduced config, for a test of the harness on the CPU (`--tiny --device
cpu`).

Writes one JSON file (`--out`, default under `build/`) after every eval
pass, so a run cut short keeps what it measured: the mAP/AR trajectory,
the per-class table at the best step, the median ms per train step and
each eval pass's wall time (host clock; on the card every step ends in a
host sync, the finite-loss check), the device and, on the card, its
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "build"
               / "quality_proof.json")
# the JAX tool's reduced config (`--tiny`)
TINY = dict(voxel_capacity=8192, min_stage_capacity=256,
            grid_extent=(512, 512, 256), preenc_npoints=512, nqueries=256,
            dec_nlayers=3, inplanes=16, num_points=20000)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--scenes", type=int, default=32)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--warmup_steps", type=int, default=200)
    p.add_argument("--eval_every", type=int, default=500)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--max_objects", type=int, default=10)
    p.add_argument("--out", type=str, default=str(DEFAULT_OUT))
    p.add_argument("--jsonl", type=str, default="")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    args = parse(argv)
    from vdetr_tpu_torch.config import VDETRConfig
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.data.synthetic import (SyntheticDetectionDataset,
                                                collate)
    from vdetr_tpu_torch.eval.ap_calculator import APCalculator
    from vdetr_tpu_torch.models.vdetr import build_model, resolve_device
    from vdetr_tpu_torch.train.engine import Trainer, evaluate

    device = resolve_device(args.device)
    steps = args.steps
    spe = max(args.scenes // args.batch, 1)  # steps per epoch
    max_epoch = max((steps + spe - 1) // spe, 1)
    warm_epochs = max(round(args.warmup_steps / spe), 1)
    cfg = VDETRConfig(
        base_lr=args.lr, warm_lr_epochs=warm_epochs, max_epoch=max_epoch,
        final_lr=args.lr / 20, batchsize_per_gpu=args.batch,
        **(TINY if args.tiny else {}))
    ds = ScannetDatasetConfig()
    data = SyntheticDetectionDataset(ds, num_points=cfg.num_points,
                                     num_scenes=args.scenes,
                                     max_objects=args.max_objects,
                                     seed=args.seed)
    batches = [collate([data[(i + j) % args.scenes]
                        for j in range(args.batch)])
               for i in range(0, args.scenes, args.batch)]

    t0 = time.time()
    model = build_model(cfg, ds, device=device)
    trainer = Trainer(cfg, model, ds, steps_per_epoch=spe, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    log(f"init {time.time() - t0:.1f}s")
    card = None
    if device.type == "cuda":
        from vdetr_tpu_torch.tools import card as card_name

        card = card_name()

    def eval_pass():
        calc = APCalculator(ds, ap_iou_thresh=[0.25, 0.5],
                            class2type_map=ds.class2type,
                            ap_config_dict=trainer.ap_config,
                            axis_align_test=cfg.axis_align_test)
        evaluate(trainer, batches, calc, logger=None)
        return calc, calc.compute_metrics()

    jsonl = open(args.jsonl, "a") if args.jsonl else None
    trajectory, losses, step_ms = [], [], []
    best = {"mAP25": -1.0}
    t0 = time.time()

    def write(final: bool):
        out = {
            "what": ("synthetic-overfit end-to-end quality proof of the "
                     "PyTorch port: train on a fixed set, evaluate the SAME "
                     "scenes through the eval step (forward, sigmoid, "
                     "device NMS on kernel N) and the VoteNet AP"),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "card": card,
            "config": {"steps": steps, "scenes": args.scenes,
                       "lr": args.lr, "batch": args.batch,
                       "num_points": cfg.num_points,
                       "nqueries": cfg.nqueries,
                       "dec_nlayers": cfg.dec_nlayers, "depth": cfg.depth,
                       "matcher_impl": cfg.matcher_impl, "tiny": args.tiny},
            "finished": final,
            "steps_done": len(losses),
            "mAP25": best["mAP25"], "mAP50": best.get("mAP50"),
            "best_step": best.get("step"),
            "trajectory": trajectory,
            "loss_first": losses[0] if losses else None,
            "loss_final": float(np.mean(losses[-50:])) if losses else None,
            "train_ms_per_step_median": (statistics.median(step_ms)
                                         if step_ms else None),
            "wall_s": time.time() - t0,
            "per_class25_at_best": best.get("per_class25"),
            "report_at_best": best.get("report", ""),
        }
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        return out

    for step in range(1, steps + 1):
        b = batches[(step - 1) % len(batches)]
        ts = time.perf_counter()
        loss, _ = trainer.train_step(b, gen)  # ends in a host sync
        step_ms.append((time.perf_counter() - ts) * 1e3)
        losses.append(loss)
        if step == 1:
            log(f"first step {step_ms[0]:.0f} ms, loss {loss:.2f}")
        if jsonl and step % 10 == 0:
            jsonl.write(json.dumps({"step": step,
                                    "loss": float(np.mean(losses[-10:]))})
                        + "\n")
            jsonl.flush()
        if step % args.eval_every == 0 or step == steps:
            te = time.time()
            calc, overall = eval_pass()
            rec = {"step": step, "loss": float(np.mean(losses[-50:])),
                   "mAP25": float(overall[0.25]["mAP"]) * 100,
                   "mAP50": float(overall[0.5]["mAP"]) * 100,
                   "AR25": float(overall[0.25]["AR"]) * 100,
                   "AR50": float(overall[0.5]["AR"]) * 100,
                   "eval_s": time.time() - te,
                   "train_ms_per_step_median": statistics.median(step_ms),
                   "iou_path": calc.iou_path}
            trajectory.append(rec)
            log(f"step {step}: loss {rec['loss']:.2f} mAP@0.25 "
                f"{rec['mAP25']:.2f} mAP@0.50 {rec['mAP50']:.2f} (eval "
                f"{rec['eval_s']:.1f}s, train "
                f"{rec['train_ms_per_step_median']:.0f} ms/step)")
            if rec["mAP25"] > best["mAP25"]:
                best = {"mAP25": rec["mAP25"], "mAP50": rec["mAP50"],
                        "step": step,
                        "per_class25": {
                            k: float(v) * 100
                            for k, v in overall[0.25].items()
                            if k not in ("mAP", "AR")},
                        "report": calc.metrics_to_str(overall)}
            write(final=step == steps)
    if jsonl:
        jsonl.close()
    out = write(final=True)
    print(json.dumps({k: out[k] for k in
                      ("mAP25", "mAP50", "best_step", "loss_final",
                       "train_ms_per_step_median", "device", "card")}))
    return out


if __name__ == "__main__":
    main()
