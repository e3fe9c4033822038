"""The train step and the eval step on one device (torch counterpart of
`vdetr_tpu/train/engine.py`; reference engine.py:59-192).

`Trainer.train_step` runs the model in train mode (batch statistics,
dropout from the caller's generator), the criterion, the backward, the
global-norm clip, and AdamW at the step's learning rate; the batch
norms' running statistics move as a side effect of the forward. A loss
that is not finite raises FloatingPointError before the parameters
change (the reference exits there).

`Trainer.eval_step` is a scan in, boxes out: the eval forward, the focal
sigmoid, and, for the published NMS variant, empty-box removal and the
greedy same-class NMS on the device (kernel N), whose keep mask the AP
calculator takes instead of its host NMS. `train_one_epoch` and
`evaluate` are the loops around the two steps; `epoch_generator` seeds
an epoch's dropout masks from (cfg.seed, epoch), so that a resumed run
draws the masks an unbroken run draws.

One device, no mesh and no retries: the JAX engine's data-parallel
shard_map and its transient-error re-dispatch are TPU machinery.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vdetr_tpu_torch.eval.ap_calculator import (config_dict_from_cfg,
                                                device_nms_supported)
from vdetr_tpu_torch.geometry.nms import nms_3d_samecls_mask
from vdetr_tpu_torch.geometry.points_in_boxes import points_in_boxes_count
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
# the decoder outputs the AP calculator consumes
EVAL_KEYS = ("box_corners", "box_corners_axis_align", "sem_cls_prob",
             "objectness_prob", "angle_prob", "center_unnormalized",
             "size_unnormalized", "angle_continuous")
# empty-box removal counts the points of a fixed subsample of at most
# this many (reference utils/ap_calculator.py:84)
EMPTY_BOX_POINTS = 40000


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
        self.ap_config = config_dict_from_cfg(cfg, dataset_config)
        self._subsample: Dict[int, torch.Tensor] = {}

    def _to_device(self, batch, keys=INPUT_KEYS + TARGET_KEYS
                   ) -> Dict[str, torch.Tensor]:
        out = {}
        for k in keys:
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

    def _empty_box_subsample(self, n: int) -> torch.Tensor:
        """The fixed subsample of min(40000, n) point indices that the
        empty-box counts read: drawn once per n from a generator seeded 0
        on the step's device, then reused. The reference draws an unseeded
        random subset per scan (utils/ap_calculator.py:84), so any fixed
        subset is within protocol; at n <= 40000 it is a reordering of
        every point, and the counts do not depend on the order."""
        sel = self._subsample.get(n)
        if sel is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            sel = torch.randperm(n, generator=gen,
                                 device=self.device)[:EMPTY_BOX_POINTS]
            self._subsample[n] = sel
        return sel

    def _nonempty(self, out, point_clouds) -> torch.Tensor:
        """(B, K) bool: the boxes that hold at least `empty_pt_thre`
        points of the fixed subsample (bottom-centred boxes), and each
        scene's highest-objectness box where every box is empty
        (vdetr_tpu/train/engine.py:282-311)."""
        boxes = torch.cat([out["center_unnormalized"],
                           out["size_unnormalized"],
                           out["angle_continuous"][..., None]], dim=-1)
        boxes[..., 2] -= boxes[..., 5] / 2  # bottom centre
        pc = point_clouds[..., :3]
        pc = pc[:, self._empty_box_subsample(pc.shape[1])]
        valid = points_in_boxes_count(pc, boxes) >= self.cfg.empty_pt_thre
        obj = out["objectness_prob"]
        none = ~valid.any(dim=1, keepdim=True)
        best = torch.nn.functional.one_hot(obj.argmax(dim=1),
                                           obj.shape[1]).bool()
        return valid | (none & best)

    def _nms_keep(self, out, point_clouds) -> torch.Tensor:
        """The device NMS's (B, K) keep mask (vdetr_tpu/train/engine.py:
        269-327): empty boxes out first when configured (`_nonempty`),
        then the greedy same-class NMS of the boxes' AABBs at `nms_iou`."""
        cfg = self.cfg
        obj = out["objectness_prob"].contiguous()
        if self.ap_config["remove_empty_box"]:
            valid = self._nonempty(out, point_clouds)
        else:
            valid = torch.ones(obj.shape, dtype=torch.bool,
                               device=obj.device)
        corners = out["box_corners_axis_align" if cfg.axis_align_test
                      else "box_corners"]
        aabbs = torch.cat([corners.min(dim=2).values,
                           corners.max(dim=2).values], dim=-1)
        classes = out["sem_cls_prob"].argmax(dim=-1)
        return nms_3d_samecls_mask(aabbs, obj, classes, valid, cfg.nms_iou)

    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        """Scan in, boxes out (counterpart of vdetr_tpu/train/engine.py:
        243-340): the eval forward under inference mode, the sigmoid of the
        class logits when the class loss is focal, the eight fields the AP
        calculator consumes, and, when the configured NMS variant is the
        device one (`device_nms_supported`), "nms_keep": the (B, K) keep
        mask of empty-box removal (when configured: `test_only`) and the
        same-class NMS. Every output stays on the trainer's device."""
        batch = self._to_device(batch, INPUT_KEYS)
        self.model.eval()
        with torch.inference_mode():
            final = dict(self.model(batch)["outputs"])
            if self.cfg.use_focal:
                final["sem_cls_prob"] = torch.sigmoid(final["sem_cls_prob"])
            out = {k: final[k] for k in EVAL_KEYS}
            if device_nms_supported(self.ap_config):
                out["nms_keep"] = self._nms_keep(out, batch["point_clouds"])
        return out


def epoch_generator(trainer: Trainer, epoch: int) -> torch.Generator:
    """The generator of epoch `epoch`'s dropout masks, on the trainer's
    device, seeded from (cfg.seed, epoch): an epoch draws the same masks
    whether the run was resumed before it or not."""
    seed = (trainer.cfg.seed * 1000003 + epoch) % (2 ** 63)
    return torch.Generator(device=trainer.device).manual_seed(seed)


def _start_trace(trainer: Trainer):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_trace(prof, profile_dir: str) -> None:
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def train_one_epoch(trainer: Trainer, loader, epoch: int,
                    generator: Optional[torch.Generator] = None,
                    log_every: int = 10,
                    logger: Optional[Callable[[str], None]] = print,
                    metrics_logger=None, log_metrics_every: int = 20,
                    profile_dir: Optional[str] = None):
    """One pass of train steps over `loader` (vdetr_tpu/train/engine.py:
    356-407; reference engine.py:59-122). `generator` (on the trainer's
    device) draws the dropout masks; a loss that is not finite raises in
    `train_step`. `metrics_logger`, if given, receives the loss dict every
    `log_metrics_every` iterations. `profile_dir`: iterations 2-4 of epoch
    0 run under torch.profiler (CPU and, on the card, CUDA activity), the
    trace written to `<profile_dir>/trace.json` (the JAX package takes a
    jax.profiler trace of the same iterations). Returns (mean loss, the
    last loss dict)."""
    losses = []
    last_dict = None
    t0 = time.time()
    prof = None
    try:
        for it, batch in enumerate(loader):
            if profile_dir and epoch == 0 and it == 2:
                prof = _start_trace(trainer)
            if prof is not None and it == 5:
                _stop_trace(prof, profile_dir)
                prof = None
            loss, loss_dict = trainer.train_step(batch, generator)
            losses.append(loss)
            last_dict = loss_dict
            if metrics_logger is not None and it % log_metrics_every == 0:
                metrics_logger.log(
                    {"loss": loss,
                     **{k: float(v) for k, v in loss_dict.items()}},
                    trainer.step, prefix="train_iter/")
            if logger and it % log_every == 0:
                avg = sum(losses[-10:]) / len(losses[-10:])
                logger(f"Epoch [{epoch}]; Iter [{it}]; Loss {avg:0.2f}; "
                       f"LR {trainer.current_lr():0.2e}; "
                       f"{time.time() - t0:0.1f}s")
    finally:
        if prof is not None:  # an epoch shorter than the window
            _stop_trace(prof, profile_dir)
    return sum(losses) / max(len(losses), 1), last_dict


def evaluate(trainer: Trainer, loader, ap_calculator, log_every: int = 10,
             logger: Optional[Callable[[str], None]] = print):
    """The eval step over `loader`, each batch's outputs handed to the AP
    calculator (vdetr_tpu/train/engine.py:410-421; reference
    engine.py:125-192). Returns the calculator."""
    for it, batch in enumerate(loader):
        ap_calculator.step(trainer.eval_step(batch), batch)
        if logger and it % log_every == 0:
            logger(f"Evaluate; Batch [{it}]")
    return ap_calculator
