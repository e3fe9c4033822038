"""Generic MLP stack and learned positional embedding (torch counterpart
of `vdetr_tpu/models/mlp.py`; reference models/helpers.py:17-141).

The reference runs 1x1 Conv1d layers over (B, C, N); here the same
weights, shaped (out, in, 1) as the reference stores them, multiply the
channel-last (B, N, C) features directly. `nn.Sequential` indices follow
the reference, so state_dict names match it.

Dropout draws its mask from an explicit `torch.Generator` that the
caller passes down the forward (the JAX package's `rngs={"dropout":
...}`), never from the global generator.
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


class Dropout(nn.Module):
    """Inverted dropout, as flax.linen.Dropout: in train mode each element
    is kept with probability 1 - p (a Bernoulli draw from `generator`) and
    scaled by 1 / (1 - p); the identity in eval mode or at p = 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in train mode needs a torch.Generator")
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                              generator=generator)
        return x * keep / (1.0 - self.p)


# flax.linen.LayerNorm's default epsilon, which the JAX package uses
LN_EPS = 1e-6


def make_norm(norm: Optional[str], dim: int) -> Optional[nn.Module]:
    """The module of a GenericMLP norm name (JAX `mlp.py:_norm`): None for
    no norm, an identity for "id" (which keeps the reference's Sequential
    index), the dense batch norm for "bn1d", a LayerNorm over the
    channels with flax's epsilon for "ln"."""
    if norm is None:
        return None
    if norm == "id":
        return nn.Identity()
    if norm == "bn1d":
        return BatchNorm1d(dim)
    if norm == "ln":
        return nn.LayerNorm(dim, eps=LN_EPS)
    raise ValueError(f"unknown norm {norm!r}")


def make_activation(name: str) -> nn.Module:
    """The module of a GenericMLP activation name (JAX `mlp.py:_act`):
    flax's `nn.gelu` is the tanh approximation, and the JAX package's
    leaky ReLU has slope 0.1."""
    if name == "relu":
        return nn.ReLU()
    if name == "gelu":
        return nn.GELU(approximate="tanh")
    if name == "leakyrelu":
        return nn.LeakyReLU(0.1)
    raise ValueError(f"unknown activation {name!r}")


class GenericMLP(nn.Module):
    """Reference models/helpers.py:74-141. Each hidden layer is conv,
    norm, activation, dropout, the norm and the dropout where given;
    `norm` is None, "id", "bn1d" (the default, as every caller but the
    query projection uses it) or "ln", `activation` "relu", "gelu" or
    "leakyrelu" (`make_norm`, `make_activation`)."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int],
                 output_dim: int, dropout: Optional[float] = None,
                 norm: Optional[str] = "bn1d", activation: str = "relu",
                 hidden_use_bias: bool = False,
                 output_use_bias: bool = True,
                 output_use_activation: bool = False,
                 output_use_norm: bool = False):
        super().__init__()
        layers = []
        dim = input_dim
        for h in hidden_dims:
            layers.append(Conv1x1(dim, h, bias=hidden_use_bias))
            if norm is not None:
                layers.append(make_norm(norm, h))
            layers.append(make_activation(activation))
            if dropout is not None:
                layers.append(Dropout(dropout))
            dim = h
        layers.append(Conv1x1(dim, output_dim, bias=output_use_bias))
        if output_use_norm and norm is not None:
            layers.append(make_norm(norm, output_dim))
        if output_use_activation:
            layers.append(make_activation(activation))
        self.layers = nn.Sequential(*layers)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for layer in self.layers:
            x = layer(x, generator) if isinstance(layer, Dropout) \
                else layer(x)
        return x


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
