"""Fourier / sine coordinate embeddings (torch counterpart of
`vdetr_tpu/models/position_embedding.py`; reference
models/position_embedding.py:21-148). Only `querypos_mlp=False` builds
one, as `pos_embedding`; the published config does not.

The Fourier matrix `gauss_B` is the JAX package's constant, drawn from
`np.random.RandomState(0)`; here it is a buffer, named as the reference
names it, which `convert.py` carries between the two packages.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from vdetr_tpu_torch.geometry.boxes import shift_scale_points


class PositionEmbeddingCoordsSine(nn.Module):
    def __init__(self, d_pos: int = 256, pos_type: str = "fourier",
                 temperature: float = 10000.0, normalize: bool = True,
                 gauss_scale: float = 1.0, d_in: int = 3):
        super().__init__()
        if pos_type not in ("fourier", "sine"):
            raise ValueError(f"unknown pos_type {pos_type!r}")
        self.d_pos = d_pos
        self.pos_type = pos_type
        self.temperature = temperature
        self.normalize = normalize
        if pos_type == "fourier":
            gauss_b = np.random.RandomState(0).randn(d_in, d_pos // 2) \
                * gauss_scale
            self.register_buffer("gauss_B", torch.from_numpy(
                gauss_b.astype(np.float32)))

    def forward(self, xyz, input_range=None,
                num_channels: Optional[int] = None):
        """xyz (B, N, d_in) -> (B, N, num_channels or d_pos). No gradient
        flows (the reference computes these under no_grad)."""
        nc = num_channels or self.d_pos
        if self.normalize and input_range is not None:
            xyz = shift_scale_points(xyz, src_range=input_range)
        xyz = xyz.detach()
        if self.pos_type == "fourier":
            proj = (2 * np.pi * xyz) @ self.gauss_B[:, :nc // 2]
            return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
        d_in = xyz.shape[-1]
        ndim = nc // d_in
        if ndim % 2 != 0:
            ndim -= 1
        rems = nc - ndim * d_in
        outs = []
        for d in range(d_in):
            cdim = ndim + (2 if rems > 0 else 0)
            rems = max(rems - 2, 0)
            dim_t = torch.arange(cdim, dtype=torch.float32,
                                 device=xyz.device)
            dim_t = self.temperature ** (2 * torch.div(
                dim_t, 2, rounding_mode="floor") / cdim)
            pos = xyz[..., d:d + 1] * (2 * math.pi) / dim_t
            emb = torch.stack([torch.sin(pos[..., 0::2]),
                               torch.cos(pos[..., 1::2])], dim=-1)
            outs.append(emb.reshape(xyz.shape[:-1] + (cdim,)))
        return torch.cat(outs, dim=-1)
