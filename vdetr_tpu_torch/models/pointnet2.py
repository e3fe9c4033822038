"""PointNet++ set-abstraction and feature-propagation modules (torch
counterpart of `vdetr_tpu/models/pointnet2.py`; reference
third_party/pointnet2/pointnet2_modules.py).

An API-parity layer over the pointnet2 ops (`ops/ball_query.py`,
`ops/gather.py`, `ops/interpolate.py`) and FPS (`ops/fps.py`, kernel B on
the card): the reference imports these modules but its train and eval
path runs none of them. Layouts are channel-last. Unlike flax, torch
needs each MLP's input width when it is built: `in_channels` is the
width of the features handed to the forward (0: none).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vdetr_tpu_torch.models.norm import BatchNorm1d
from vdetr_tpu_torch.ops.ball_query import ball_query
from vdetr_tpu_torch.ops.fps import furthest_point_sample
from vdetr_tpu_torch.ops.gather import grouping_operation
from vdetr_tpu_torch.ops.interpolate import (interpolate_weights,
                                             three_interpolate, three_nn)


class QueryAndGroup(nn.Module):
    """Ball query and relative-coordinate grouping (reference
    pointnet2_utils.py QueryAndGroup)."""

    def __init__(self, radius: float, nsample: int, use_xyz: bool = True):
        super().__init__()
        self.radius, self.nsample, self.use_xyz = radius, nsample, use_xyz

    def forward(self, xyz, new_xyz, features=None):
        """xyz (B, N, 3); new_xyz (B, np, 3); features (B, N, C) or None.
        Returns (B, np, nsample, C'), C' = C (+ 3 first with use_xyz)."""
        idx = ball_query(self.radius, self.nsample, xyz, new_xyz)
        grouped_xyz = grouping_operation(xyz.transpose(1, 2), idx
                                         ).permute(0, 2, 3, 1)
        parts = [grouped_xyz - new_xyz[:, :, None, :]] if self.use_xyz \
            else []
        if features is not None:
            parts.append(grouping_operation(features.transpose(1, 2), idx
                                            ).permute(0, 2, 3, 1))
        return torch.cat(parts, dim=-1)


class SharedMLP(nn.Module):
    """A per-point MLP (a stack of 1x1 convs) with BN and ReLU: `layer<i>`
    without bias, `norm<i>`, as the JAX module names them."""

    def __init__(self, in_channels: int, dims: Sequence[int]):
        super().__init__()
        self.dims = list(dims)
        widths = [in_channels] + self.dims
        for i, d in enumerate(self.dims):
            self.add_module(f"layer{i}", nn.Linear(widths[i], d, bias=False))
            self.add_module(f"norm{i}", BatchNorm1d(d))

    def forward(self, x):
        flat = x.reshape(x.shape[0], -1, x.shape[-1])
        for i in range(len(self.dims)):
            flat = F.relu(getattr(self, f"norm{i}")(
                getattr(self, f"layer{i}")(flat)))
        return flat.reshape(x.shape[:-1] + (self.dims[-1],))


class PointnetSAModuleVotes(nn.Module):
    """Set abstraction: FPS centers, ball-query grouping, the shared MLP
    and a max pool (reference pointnet2_modules.py:161-269)."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 mlp: Sequence[int], use_xyz: bool = True,
                 in_channels: int = 0):
        super().__init__()
        self.npoint = npoint
        self.grouper = QueryAndGroup(radius, nsample, use_xyz)
        self.mlp = SharedMLP(in_channels + 3 * use_xyz, mlp)

    def forward(self, xyz, features=None, inds=None):
        """xyz (B, N, 3), features (B, N, in_channels) or None, inds (B,
        npoint) centers or None (FPS). Returns (new_xyz, pooled (B,
        npoint, C), inds)."""
        if inds is None:
            inds = furthest_point_sample(xyz.contiguous(), self.npoint)
        new_xyz = xyz.gather(1, inds.long()[..., None].expand(-1, -1, 3))
        feats = self.mlp(self.grouper(xyz, new_xyz, features))
        return new_xyz, feats.max(dim=2).values, inds


class PointnetFPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation and the
    shared MLP (reference pointnet2_modules.py:352-411). `in_channels`:
    the known features' width plus the unknown's."""

    def __init__(self, mlp: Sequence[int], in_channels: int):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp)

    def forward(self, unknown, known, unknown_feats, known_feats):
        """unknown (B, n, 3); known (B, m, 3) or None (every unknown point
        takes the known features' mean); features channel-last."""
        if known is not None:
            dist, idx = three_nn(unknown, known)
            interp = three_interpolate(known_feats.transpose(1, 2), idx,
                                       interpolate_weights(dist)
                                       ).transpose(1, 2)
        else:
            interp = known_feats.mean(1, keepdim=True).expand(
                -1, unknown.shape[1], -1)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)
