"""Learning-rate schedule: linear warmup, then cosine or a two-step decay
(torch counterpart of `vdetr_tpu/train/schedule.py:16-48`; reference
engine.py:24-56). The rate is a function of the step index, set on the
optimizer before every step."""

from __future__ import annotations

import math


def make_lr_schedule(cfg, steps_per_epoch: int):
    """step -> learning rate (a float)."""
    max_steps = max(cfg.max_epoch * steps_per_epoch, 1)
    warm_frac = cfg.warm_lr_epochs / cfg.max_epoch if cfg.max_epoch else 0.0
    if cfg.lr_scheduler != "cosine":
        step_1, step_2 = (int(x) for x in cfg.step_epoch.split("_"))

    def sched(step: int) -> float:
        cen = min(max(step / max_steps, 0.0), 1.0)
        if cen <= warm_frac and cfg.warm_lr_epochs > 0:
            return cfg.warm_lr + cen * cfg.max_epoch * (
                (cfg.base_lr - cfg.warm_lr) / max(cfg.warm_lr_epochs, 1))
        if cfg.lr_scheduler == "cosine":
            return cfg.final_lr + 0.5 * (cfg.base_lr - cfg.final_lr) * (
                1 + math.cos(math.pi * cen))
        if cen < step_1 / cfg.max_epoch:
            return cfg.base_lr
        if cen < step_2 / cfg.max_epoch:
            return cfg.base_lr / 10
        return cfg.base_lr / 100

    return sched
