"""Normalization layers (torch counterpart of
`vdetr_tpu/models/norm.py:20-141`).

The parameters keep torch's names (`weight`, `bias`, `running_mean`,
`running_var`) and the masked voxel norms nest theirs under `bn` as
MinkowskiBatchNorm does, so the port's state_dict uses the reference
V-DETR names. The normalization is written out, channel-last, rather
than calling `F.batch_norm`, which would reach cuDNN on the GPU.

In train mode (`module.train()`) the batch norms take their statistics
from the batch, as the JAX package does: the mean and the biased
variance max(E[x^2] - E[x]^2, 0), over the valid rows of (B, V) for the
masked voxel norm and over all of (B, N) for the dense one. The running
statistics then move by momentum 0.1 towards the batch mean and the
unbiased variance. In eval mode they normalize with the running
statistics.

Sync-BN (`sync_batch_norms`, the JAX package's `axis_name`): with a
process group of several ranks, each batch norm sums its (count, sum,
sum of squares) over the ranks in one all-reduce, whose backward sums
the cotangents over the ranks; the mean, the biased variance and the
running statistics' unbiased variance then come from the global count,
as the ranks' batches were one batch. Without a group nothing of this
runs.
"""

from __future__ import annotations

import torch
from torch import nn

from vdetr_tpu_torch.parallel.dist import all_reduce_sum

MOMENTUM = 0.1  # torch convention: new = (1 - m) * old + m * batch


class BatchNorm1d(nn.Module):
    """BatchNorm over the last axis of (B, N, C), statistics over (B, N)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.group = None  # sync-BN's process group (`sync_batch_norms`)

    def normalize(self, x, mask=None):
        """Normalize x (B, N, C); in train mode with statistics over the
        rows where `mask` (B, N) is true (all rows when None)."""
        if self.training:
            if mask is None:
                cnt = torch.tensor(float(x.shape[0] * x.shape[1]),
                                   device=x.device)
                s, sq = x.sum(dim=(0, 1)), (x * x).sum(dim=(0, 1))
            else:
                m = mask.to(x.dtype)[..., None]
                cnt = m.sum()
                s, sq = (x * m).sum(dim=(0, 1)), (x * x * m).sum(dim=(0, 1))
            if self.group is not None:
                c = s.shape[0]
                packed = all_reduce_sum(torch.cat([cnt.reshape(1), s, sq]),
                                        self.group)
                cnt, s, sq = packed[0], packed[1:c + 1], packed[c + 1:]
            if mask is not None:
                cnt = cnt.clamp(min=1.0)
            mean = s / cnt
            var = (sq / cnt - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                self.running_mean.mul_(1 - MOMENTUM).add_(MOMENTUM * mean)
                self.running_var.mul_(1 - MOMENTUM).add_(MOMENTUM * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias

    def forward(self, x):
        return self.normalize(x)


class MaskedBatchNorm(nn.Module):
    """BatchNorm of padded voxel features (B, V, C); invalid rows are 0
    and take no part in the statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.bn = BatchNorm1d(num_features, eps)

    def forward(self, x, mask):
        return torch.where(mask[..., None], self.bn.normalize(x.float(), mask),
                           0.0)


class MaskedInstanceNorm(nn.Module):
    """Per-sample instance norm over the valid voxels (the stem's norm
    when stem_bn=False, reference models/mink_resnet.py:41)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x, mask):
        x = x.float()
        m = mask.to(x.dtype)[..., None]
        cnt = m.sum(dim=1, keepdim=True).clamp(min=1.0)
        mean = (x * m).sum(dim=1, keepdim=True) / cnt
        var = ((x - mean) ** 2 * m).sum(dim=1, keepdim=True) / cnt
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[..., None], y, 0.0)


def sync_batch_norms(model: nn.Module, group) -> None:
    """Sync-BN: every batch norm of `model` takes its train-mode
    statistics over the ranks of `group` (None: over its own batch). The
    state_dict's names do not change."""
    for m in model.modules():
        if isinstance(m, BatchNorm1d):
            m.group = group
