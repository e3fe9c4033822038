"""The train step on one device (torch counterpart of
`vdetr_tpu/train/engine.py:91-240,356-407`; reference engine.py:59-122).

`Trainer.train_step` runs the model in train mode (batch statistics,
dropout from the caller's generator), the criterion, the backward, the
global-norm clip, and AdamW at the step's learning rate; the batch
norms' running statistics move as a side effect of the forward. A loss
that is not finite raises FloatingPointError before the parameters
change (the reference exits there). One device, no mesh and no retries:
the JAX engine's data-parallel shard_map and its transient-error
re-dispatch are TPU machinery.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vdetr_tpu_torch.models.vdetr import resolve_device
from vdetr_tpu_torch.train.criterion import SetCriterion
from vdetr_tpu_torch.train.optimizer import (build_optimizer,
                                             clip_by_global_norm)
from vdetr_tpu_torch.train.schedule import make_lr_schedule

INPUT_KEYS = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max",
              "point_validity")
TARGET_KEYS = ("gt_box_corners", "gt_box_centers", "gt_box_centers_normalized",
               "gt_box_sizes", "gt_box_sizes_normalized", "gt_box_angles",
               "gt_angle_class_label", "gt_angle_residual_label",
               "gt_box_sem_cls_label", "gt_box_present")


class Trainer:
    """Owns the criterion, the optimizer and the step count for one model
    on one device: `device` (default: the CUDA card; raises without one).
    The model is moved there."""

    def __init__(self, cfg, model: torch.nn.Module, dataset_config,
                 steps_per_epoch: int, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.criterion = SetCriterion(cfg, dataset_config)
        self.lr_schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.optimizer = build_optimizer(cfg, self.model)
        self.step = 0

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k in INPUT_KEYS + TARGET_KEYS:
            if k in batch:
                v = batch[k]
                v = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                out[k] = v.to(self.device, non_blocking=True)
        return out

    def current_lr(self) -> float:
        return float(self.lr_schedule(self.step))

    def train_step(self, batch, generator: Optional[torch.Generator] = None
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
        """One step on `batch` (numpy arrays or tensors with the model
        inputs and the GT fields). `generator`, on the trainer's device,
        draws every dropout mask. Returns (loss, loss_dict), the loss a
        float and the dict's entries detached device scalars."""
        batch = self._to_device(batch)
        inputs = {k: batch[k] for k in INPUT_KEYS if k in batch}
        self.model.train()
        lr = self.current_lr()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        outputs = self.model(inputs, generator=generator)
        loss, loss_dict = self.criterion(outputs, batch)
        loss.backward()
        if self.cfg.clip_gradient > 0:
            clip_by_global_norm(self.model.parameters(),
                                self.cfg.clip_gradient)
        loss_val = float(loss.detach())
        if not math.isfinite(loss_val):
            raise FloatingPointError(
                f"loss is not finite at step {self.step}: {loss_val} "
                "(reference engine.py:100-102 stops here)")
        self.optimizer.step()
        self.step += 1
        return loss_val, {k: v.detach() for k, v in loss_dict.items()}
