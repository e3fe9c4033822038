"""Generic MLP stack and learned positional embedding (torch counterpart
of `vdetr_tpu/models/mlp.py`; reference models/helpers.py:17-141).

The reference runs 1x1 Conv1d layers over (B, C, N); here the same
weights, shaped (out, in, 1) as the reference stores them, multiply the
channel-last (B, N, C) features directly. `nn.Sequential` indices follow
the reference, so state_dict names match it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vdetr_tpu_torch.models.norm import BatchNorm1d


class Conv1x1(nn.Module):
    """A reference Conv1d(kernel_size=1) applied to channel-last input.
    The weight is left uninitialised: `models.vdetr.init_weights` fills
    every parameter from an explicit generator."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, 1))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight[:, :, 0], self.bias)


class GenericMLP(nn.Module):
    """Reference models/helpers.py:74-141 with the published choices:
    BatchNorm and ReLU. Each hidden layer is conv, norm, relu, dropout
    (dropout is the identity in eval)."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int],
                 output_dim: int, dropout: Optional[float] = None,
                 output_use_bias: bool = True,
                 output_use_activation: bool = False,
                 output_use_norm: bool = False):
        super().__init__()
        layers = []
        dim = input_dim
        for h in hidden_dims:
            layers += [Conv1x1(dim, h, bias=False), BatchNorm1d(h),
                       nn.ReLU()]
            if dropout is not None:
                layers.append(nn.Dropout(dropout))
            dim = h
        layers.append(Conv1x1(dim, output_dim, bias=output_use_bias))
        if output_use_norm:
            layers.append(BatchNorm1d(output_dim))
        if output_use_activation:
            layers.append(nn.ReLU())
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class PositionEmbeddingLearned(nn.Module):
    """Conv + BN + ReLU + Conv on coordinates (reference
    models/helpers.py:17-33). Input (B, N, D) -> (B, N, F)."""

    def __init__(self, input_dim: int, num_pos_feats: int = 256):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            Conv1x1(input_dim, num_pos_feats),
            BatchNorm1d(num_pos_feats),
            nn.ReLU(),
            Conv1x1(num_pos_feats, num_pos_feats),
        )

    def forward(self, xyz):
        return self.position_embedding_head(xyz)
