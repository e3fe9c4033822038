"""CLI: training / evaluation orchestration on one CUDA card (the port of
`vdetr_tpu/main.py`; reference main.py).

The flag surface is the JAX package's: every VDETRConfig field becomes a
flag, bools as 0/1, except the mesh fields (one card, so the global batch
is `--batchsize_per_gpu`). The sparse convs run on the keyed route, the
port's default. The flow is the JAX `main`'s: an epoch loop of
`train_one_epoch`, a checkpoint every epoch and numbered snapshots in the
last tenth, eval passes (`epoch % eval_every_epoch == 0`, the last epoch
and epoch 10) over the whole val set (`pad_last`), the best checkpoint by
mAP@0.25, resume from `<checkpoint_dir>/checkpoint`, `final_eval.txt` and
`final_eval.pkl`; `--test_only` evaluates a port checkpoint, a JAX
checkpoint directory or a reference `.pth`, with `--auto_test`
(the model's flags from the checkpoint), `--test_size` and `--tta`.

Usage:
  python -m vdetr_tpu_torch.main --dataset_name synthetic --max_epoch 2
  python -m vdetr_tpu_torch.main --dataset_name scannet \\
      --dataset_root_dir scannet_data/ --checkpoint_dir ckpt/
  python -m vdetr_tpu_torch.main --dataset_name scannet --test_only 1 \\
      --auto_test 1 --test_ckpt ckpt/checkpoint_best ...

`main(argv, device=None)`: the card unless the caller passes `device`
(the tests pass "cpu").
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
from typing import Optional

import numpy as np

from vdetr_tpu_torch.config import AUTO_TEST_IGNORE_KEYS, VDETRConfig

# the JAX package's mesh fields: one card here, nothing to shard
_NOT_FLAGS = ("grid_extent", "mesh_shape", "mesh_axis_names")


def _flag_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def make_args_parser() -> argparse.ArgumentParser:
    """Every VDETRConfig field becomes a flag (bools as 0/1, so that a
    True default can be turned off)."""
    parser = argparse.ArgumentParser(
        "V-DETR 3D detection on one CUDA card (vdetr_tpu_torch)",
        add_help=True)
    defaults = VDETRConfig()
    for f in dataclasses.fields(VDETRConfig):
        if f.name in _NOT_FLAGS:
            continue
        default = getattr(defaults, f.name)
        if isinstance(default, bool):
            kind = _flag_bool
        elif isinstance(default, (int, float)):
            kind = type(default)
        else:
            kind = str
        parser.add_argument(f"--{f.name}", type=kind, default=default)
    return parser


def config_from_args(args) -> VDETRConfig:
    kw = {f.name: getattr(args, f.name)
          for f in dataclasses.fields(VDETRConfig) if hasattr(args, f.name)}
    return VDETRConfig(**kw)


def build_datasets(cfg: VDETRConfig):
    from vdetr_tpu_torch.data.dataset_config import get_dataset_config

    ds_cfg = get_dataset_config(cfg.dataset_name)
    if cfg.dataset_name == "synthetic":
        from vdetr_tpu_torch.data.synthetic import SyntheticDetectionDataset

        train = SyntheticDetectionDataset(ds_cfg, cfg.num_points,
                                          num_scenes=64, seed=cfg.seed)
        val = SyntheticDetectionDataset(ds_cfg, cfg.num_points,
                                        num_scenes=16, seed=cfg.seed + 1)
    elif cfg.dataset_name == "scannet":
        from vdetr_tpu_torch.data.scannet import ScannetDetectionDataset

        train = ScannetDetectionDataset(cfg, ds_cfg, "train")
        val = ScannetDetectionDataset(cfg, ds_cfg, "val")
    else:
        raise ValueError(cfg.dataset_name)
    return {"train": train, "test": val}, ds_cfg


def _reference_checkpoint(cfg: VDETRConfig):
    """(the loaded reference .pth, cfg with --auto_test's restored
    flags)."""
    import torch

    from vdetr_tpu_torch.convert import reference_args_to_config

    ckpt = torch.load(cfg.test_ckpt, map_location="cpu", weights_only=False)
    if cfg.auto_test and isinstance(ckpt, dict) and "args" in ckpt:
        cfg = reference_args_to_config(ckpt["args"], cfg,
                                       AUTO_TEST_IGNORE_KEYS)
    return ckpt, cfg


def _load_reference_weights(model, ckpt) -> None:
    from vdetr_tpu_torch.convert import from_reference_state_dict

    sd = from_reference_state_dict(ckpt["model"] if "model" in ckpt
                                   else ckpt)
    missing, unused = model.load_state_dict(sd, strict=False)
    if missing:
        raise ValueError(f"torch checkpoint missing {len(missing)} tensors, "
                         f"e.g. {missing[:5]}")
    if unused:
        print(f"warning: {len(unused)} unused ckpt tensors, e.g. "
              f"{unused[:5]}")
    print(f"imported torch checkpoint at epoch {ckpt.get('epoch')}")


def main(argv: Optional[list] = None, device=None):
    import torch

    from vdetr_tpu_torch.data.loader import prefetch_loader
    from vdetr_tpu_torch.eval.ap_calculator import (APCalculator,
                                                    config_dict_from_cfg)
    from vdetr_tpu_torch.models.vdetr import build_model, resolve_device
    from vdetr_tpu_torch.train import checkpoint as ckpt_io
    from vdetr_tpu_torch.train.engine import (Trainer, epoch_generator,
                                              evaluate, train_one_epoch)
    from vdetr_tpu_torch.utils.logging import MetricsLogger

    args = make_args_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(device)

    torch_ckpt = None
    if cfg.test_only and cfg.test_ckpt and cfg.test_ckpt.endswith(".pth"):
        torch_ckpt, cfg = _reference_checkpoint(cfg)
    elif cfg.test_only and cfg.auto_test and cfg.test_ckpt:
        cfg = ckpt_io.auto_reload_config(cfg, cfg.test_ckpt)

    np.random.seed(cfg.seed)
    datasets, ds_cfg = build_datasets(cfg)
    batch = cfg.batchsize_per_gpu
    steps_per_epoch = max(len(datasets["train"]) // batch, 1)
    model = build_model(cfg, ds_cfg,
                        generator=torch.Generator().manual_seed(cfg.seed),
                        device=device)
    trainer = Trainer(cfg, model, ds_cfg, steps_per_epoch, device=device)

    def eval_pass():
        calc = APCalculator(
            ds_cfg, ap_iou_thresh=[0.25, 0.5],
            class2type_map=ds_cfg.class2type,
            ap_config_dict=config_dict_from_cfg(cfg, ds_cfg),
            axis_align_test=cfg.axis_align_test,
        )
        # pad_last: every val scan is scored (the reference evaluates all
        # scans at bs=1, engine.py:125-192; dropping the tail biases mAP)
        loader = prefetch_loader(datasets["test"], batch, shuffle=False,
                                 pad_last=True,
                                 num_workers=cfg.dataset_num_workers)
        if cfg.tta:
            from vdetr_tpu_torch.eval.tta import tta_eval_step

            for b in loader:
                calc.step(tta_eval_step(trainer.eval_step, b), b)
        else:
            evaluate(trainer, loader, calc)
        overall = calc.compute_metrics()
        print(calc.metrics_to_str(overall))
        return calc, overall

    if cfg.test_only:
        if torch_ckpt is not None:
            _load_reference_weights(trainer.model, torch_ckpt)
        elif cfg.test_ckpt and ckpt_io.is_jax_checkpoint(cfg.test_ckpt):
            header = ckpt_io.load_jax_checkpoint(cfg.test_ckpt,
                                                 trainer.model, cfg)
            print(f"loaded JAX checkpoint at epoch {header.get('epoch')}")
        elif cfg.test_ckpt:
            header = ckpt_io.load_checkpoint(cfg.test_ckpt, trainer)
            print(f"loaded checkpoint at epoch {header.get('epoch')}")
        calc, overall = eval_pass()
        if cfg.test_size:
            for size in ("S", "M", "L"):
                print(f"==== size bucket {size} ====")
                print(calc.metrics_to_str(calc.compute_metrics(size=size)))
        return overall

    # ---- training (reference do_train, main.py:237-434) ----
    start_epoch = 0
    best = {}
    if cfg.checkpoint_dir:
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        last_epoch, best = ckpt_io.resume_if_possible(cfg.checkpoint_dir,
                                                      trainer)
        start_epoch = last_epoch + 1
    mlogger = MetricsLogger(cfg.checkpoint_dir, run_name="train")
    wandb = None
    if cfg.wandb_activate:
        try:  # optional: the JSONL log is always written
            import wandb as _wandb

            if cfg.wandb_key:  # reference main.py:560
                _wandb.login(key=cfg.wandb_key)
            run_name = os.path.basename(cfg.checkpoint_dir or "run")
            _wandb.init(project=cfg.wandb_project, entity=cfg.wandb_entity,
                        name=run_name, id=run_name)
            wandb = _wandb
        except Exception as e:  # a logging sink must not stop training
            print(f"wandb unavailable ({e}); logging to JSONL only")
    try:
        for epoch in range(start_epoch, cfg.max_epoch):
            loader = prefetch_loader(datasets["train"], batch, shuffle=True,
                                     seed=cfg.seed + epoch,
                                     num_workers=cfg.dataset_num_workers)
            mean_loss, loss_dict = train_one_epoch(
                trainer, loader, epoch, epoch_generator(trainer, epoch),
                log_every=cfg.log_every, metrics_logger=mlogger,
                log_metrics_every=cfg.log_metrics_every,
                profile_dir=cfg.profile_dir)
            if cfg.checkpoint_dir:
                ckpt_io.save_checkpoint(cfg.checkpoint_dir, trainer, cfg,
                                        epoch, best)
                # numbered snapshots in the last tenth of training
                # (reference main.py:319-332)
                if (cfg.save_separate_checkpoint_every_epoch > 0
                        and epoch >= cfg.max_epoch * 0.9
                        and epoch % cfg.save_separate_checkpoint_every_epoch
                        == 0):
                    ckpt_io.save_checkpoint(
                        cfg.checkpoint_dir, trainer, cfg, epoch, best,
                        filename=f"checkpoint_{epoch:04d}")
            mlogger.log({"loss": mean_loss,
                         **{k: float(v) for k, v in
                            (loss_dict or {}).items()}},
                        epoch, prefix="train/")
            if wandb is not None:
                wandb.log({"train/loss": float(mean_loss)}, step=epoch)
            if (epoch % cfg.eval_every_epoch == 0
                    or epoch == cfg.max_epoch - 1 or epoch == 10):
                _, overall = eval_pass()
                val_metrics = (
                    {f"mAP_{t}": overall[t]["mAP"] for t in overall}
                    | {f"AR_{t}": overall[t]["AR"] for t in overall})
                mlogger.log(val_metrics, epoch, prefix="val/")
                if wandb is not None:
                    wandb.log({f"val/{k}": float(v)
                               for k, v in val_metrics.items()}, step=epoch)
                cur = overall[0.25]["mAP"]
                if cur > best.get("mAP_0.25", -1):
                    best = {"mAP_0.25": float(cur),
                            "mAP_0.5": float(overall[0.5]["mAP"]),
                            "epoch": epoch}
                    if cfg.checkpoint_dir:
                        ckpt_io.save_checkpoint(cfg.checkpoint_dir, trainer,
                                                cfg, epoch, best,
                                                filename=ckpt_io.BEST)
                print(f"epoch {epoch}: loss {mean_loss:.3f} "
                      f"mAP@0.25 {cur * 100:.2f} (best {best})")
    finally:
        mlogger.close()

    # final artifacts (reference main.py:260-261, 422-434)
    calc, overall = eval_pass()
    if cfg.checkpoint_dir:
        with open(os.path.join(cfg.checkpoint_dir, "final_eval.txt"),
                  "w") as f:
            f.write(calc.metrics_to_str(overall))
        with open(os.path.join(cfg.checkpoint_dir, "final_eval.pkl"),
                  "wb") as f:
            pickle.dump({float(k): dict(v) for k, v in overall.items()}, f)
    return overall


if __name__ == "__main__":
    main()
