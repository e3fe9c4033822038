"""Rank bodies of the port's data-parallel tests
(tests/test_torch_parallel.py).

The ranks are spawned processes (`vdetr_tpu_torch.tools.run_ranks`), which
unpickle their target by module: this module imports no jax, so a rank
starts with torch and the port alone. Each rank runs torch on one thread
(the tier-1 run has several workers on the machine's cores) and meets the
others over gloo.
"""

import builtins
import os

import torch

from vdetr_tpu_torch.parallel import dist


def evaluate_scenes(cfg, data, global_batch: int, group=None):
    """`engine.evaluate` of the tiny model of `cfg` (weights from seed 0)
    over `data` at `global_batch` with `pad_last`, this rank's rows of
    each batch (all of them without a group). Returns (the calculator's
    scans and metrics, the outputs and batch fields it was handed per
    step), on the CPU, numpy where the calculator keeps numpy."""
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.data.loader import prefetch_loader
    from vdetr_tpu_torch.eval.ap_calculator import (APCalculator,
                                                    config_dict_from_cfg)
    from vdetr_tpu_torch.models.vdetr import build_model
    from vdetr_tpu_torch.train.engine import Trainer, evaluate

    ds = ScannetDatasetConfig()
    model = build_model(cfg, ds, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    trainer = Trainer(cfg, model, ds, 1, device="cpu", group=group)
    handed = []

    class Recording(APCalculator):
        def step(self, outputs, targets):
            handed.append(({k: torch.as_tensor(v).clone()
                            for k, v in outputs.items()},
                           {k: torch.as_tensor(v).clone()
                            for k, v in targets.items()}))
            super().step(outputs, targets)

    calc = Recording(ds, ap_iou_thresh=[0.25, 0.5],
                     class2type_map=ds.class2type,
                     ap_config_dict=config_dict_from_cfg(cfg, ds))
    loader = prefetch_loader(data, global_batch, shuffle=False,
                             pad_last=True, rank=dist.rank(group),
                             world=dist.world(group))
    evaluate(trainer, loader, calc, logger=None)
    metrics = calc.compute_metrics() if calc.scan_cnt else None
    return {"scan_cnt": calc.scan_cnt, "metrics": metrics,
            "handed": handed}


def eval_rank(rank: int, spec: dict) -> dict:
    torch.set_num_threads(1)
    group = dist.init(rank, spec["world"], spec["init_method"], "gloo",
                      timeout=spec["timeout"])
    try:
        return evaluate_scenes(spec["cfg"], spec["data"],
                               spec["global_batch"], group)
    finally:
        dist.destroy(group)


def cli_rank(rank: int, spec: dict) -> dict:
    """`vdetr_tpu_torch.main.main(spec["argv"], device="cpu")` as rank
    `rank` of a torchrun-style launch (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT). Records every file the rank opens for
    writing or saves with torch.save, and the model it holds at each
    `save_checkpoint`; returns them with `main`'s metrics."""
    from vdetr_tpu_torch import main as cli
    from vdetr_tpu_torch.train import checkpoint as ckpt_io

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(spec["world"]), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(spec["port"]))
    written, saved = [], {}
    real_open, real_save = builtins.open, ckpt_io.save_checkpoint
    real_torch_save = torch.save

    def recording_open(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+"):
            written.append(os.fspath(file))
        return real_open(file, mode, *args, **kwargs)

    def recording_save(checkpoint_dir, trainer, cfg, epoch, best=None,
                       filename=ckpt_io.LATEST):
        saved[filename] = {k: v.detach().clone() for k, v in
                           trainer.model.state_dict().items()}
        return real_save(checkpoint_dir, trainer, cfg, epoch, best,
                         filename)

    def recording_torch_save(obj, f, *args, **kwargs):
        written.append(os.fspath(f))
        return real_torch_save(obj, f, *args, **kwargs)

    builtins.open = recording_open
    ckpt_io.save_checkpoint = recording_save
    torch.save = recording_torch_save
    try:
        overall = cli.main(spec["argv"], device="cpu")
    finally:
        builtins.open, ckpt_io.save_checkpoint = real_open, real_save
        torch.save = real_torch_save
    return {"overall": {float(t): dict(v) for t, v in overall.items()},
            "written": written, "saved": saved}
