"""Normalization layers in eval mode (torch counterpart of
`vdetr_tpu/models/norm.py:20-141`).

The parameters keep torch's names (`weight`, `bias`, `running_mean`,
`running_var`) and the masked voxel norms nest theirs under `bn` as
MinkowskiBatchNorm does, so the port's state_dict uses the reference
V-DETR names. The normalization is written out, channel-last, rather
than calling `F.batch_norm`, which would reach cuDNN on the GPU.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm1d(nn.Module):
    """Eval-mode BatchNorm over the last axis with running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias


class MaskedBatchNorm(nn.Module):
    """BatchNorm of padded voxel features (B, V, C); invalid rows are 0."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.bn = BatchNorm1d(num_features, eps)

    def forward(self, x, mask):
        return torch.where(mask[..., None], self.bn(x.float()), 0.0)


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
