"""AdamW with optax's defaults and the optional bias / 1-d parameter
weight-decay exclusion, plus global-norm gradient clipping (torch
counterpart of `vdetr_tpu/train/optimizer.py:22-35`; reference
optimizer.py:4-26 and engine.py:105-107).

`torch.optim.AdamW` is optax.adamw's update: decoupled weight decay
scaled by the learning rate, beta 0.9 / 0.999, eps 1e-8 outside the
square root. The clip is written out as optax.clip_by_global_norm does
it, g / ||g|| * max_norm when ||g|| >= max_norm, on the device and
without a host synchronization (torch's clip_grad_norm_ adds 1e-6 to
the norm).
"""

from __future__ import annotations

from typing import Iterable

import torch


def build_optimizer(cfg, model: torch.nn.Module) -> torch.optim.AdamW:
    """AdamW over the model's parameters; with cfg.filter_biases_wd the
    1-d parameters (biases, norm scales) take no weight decay."""
    params = [p for p in model.parameters() if p.requires_grad]
    if cfg.filter_biases_wd:
        groups = [
            {"params": [p for p in params if p.ndim > 1]},
            {"params": [p for p in params if p.ndim <= 1],
             "weight_decay": 0.0},
        ]
    else:
        groups = [{"params": params}]
    return torch.optim.AdamW(groups, lr=cfg.base_lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=cfg.weight_decay)


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.nn.Parameter],
                        max_norm: float) -> torch.Tensor:
    """Scale the gradients in place so that their global norm is at most
    `max_norm`; returns the norm before clipping (a device scalar)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = norm >= max_norm
    # g / norm * max_norm where clipping, g / 1 * 1 (exactly g) elsewhere
    torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0))
    return norm
