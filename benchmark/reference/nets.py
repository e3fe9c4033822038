"""Norms, MLPs, the SparseResNet (BasicBlock depths) and the FPN, plain
(frozen copy of `vdetr_tpu_torch/models/norm.py`, `models/mlp.py` and
`models/backbone.py`, keyed route, float32, one process)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.sparse import (VoxelGrid, downsample_grid,
                                        sparse_conv, sparse_conv_down,
                                        sparse_conv_transpose)

MOMENTUM = 0.1
LN_EPS = 1e-6


class BatchNorm1d(nn.Module):
    """Batch norm over the last axis of (B, N, C): in train mode the mean
    and the biased variance max(E[x^2] - E[x]^2, 0) over the rows where
    `mask` holds, the running statistics moved by momentum 0.1 towards
    the mean and the unbiased variance."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def normalize(self, x, mask=None):
        if self.training:
            if mask is None:
                cnt = torch.tensor(float(x.shape[0] * x.shape[1]),
                                   device=x.device)
                s, sq = x.sum(dim=(0, 1)), (x * x).sum(dim=(0, 1))
            else:
                m = mask.to(x.dtype)[..., None]
                cnt = m.sum()
                s, sq = (x * m).sum(dim=(0, 1)), (x * x * m).sum(dim=(0, 1))
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
    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.bn = BatchNorm1d(num_features, eps)

    def forward(self, x, mask):
        return torch.where(mask[..., None], self.bn.normalize(x, mask), 0.0)


class Conv1x1(nn.Module):
    """A Conv1d(kernel_size=1) over channel-last input."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, 1))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight[:, :, 0], self.bias)


class Dropout(nn.Module):
    """Inverted dropout, each element kept with probability 1 - p by a
    Bernoulli draw from the caller's generator."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                              generator=generator)
        return x * keep / (1.0 - self.p)


def make_norm(norm, dim):
    if norm is None:
        return None
    if norm == "bn1d":
        return BatchNorm1d(dim)
    if norm == "ln":
        return nn.LayerNorm(dim, eps=LN_EPS)
    raise ValueError(f"the reference has no norm {norm!r}")


def make_activation(name):
    if name == "relu":
        return nn.ReLU()
    raise ValueError(f"the reference has no activation {name!r}")


class GenericMLP(nn.Module):
    def __init__(self, input_dim: int, hidden_dims: Sequence[int],
                 output_dim: int, dropout: Optional[float] = None,
                 norm: Optional[str] = "bn1d", activation: str = "relu",
                 hidden_use_bias: bool = False, output_use_bias: bool = True,
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

    def forward(self, x, generator=None):
        for layer in self.layers:
            x = layer(x, generator) if isinstance(layer, Dropout) \
                else layer(x)
        return x


class PositionEmbeddingLearned(nn.Module):
    def __init__(self, input_dim: int, num_pos_feats: int = 256):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            Conv1x1(input_dim, num_pos_feats), BatchNorm1d(num_pos_feats),
            nn.ReLU(), Conv1x1(num_pos_feats, num_pos_feats))

    def forward(self, xyz):
        return self.position_embedding_head(xyz)


# --------------------------------------------------------------------------
# backbone
# --------------------------------------------------------------------------

class SparseConv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.kernel = nn.Parameter(torch.empty(kernel_size ** 3, cin, cout))

    def forward(self, grid):
        return sparse_conv(grid, self.kernel, self.kernel_size)


class SparseConvDown(nn.Module):
    def __init__(self, cin: int, cout: int, out_capacity: int,
                 kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.out_capacity = out_capacity
        self.kernel = nn.Parameter(torch.empty(kernel_size ** 3, cin, cout))

    def forward(self, grid, out_grid=None):
        if out_grid is None:
            out_grid = downsample_grid(grid, self.out_capacity)
        return sparse_conv_down(grid, self.kernel, out_grid,
                                self.kernel_size)


class SparseConvTranspose(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(8, cin, cout))

    def forward(self, coarse, fine_sites):
        return sparse_conv_transpose(coarse, fine_sites, self.kernel)


class SparseBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 out_capacity: Optional[int] = None):
        super().__init__()
        self.stride = stride
        self.out_capacity = out_capacity
        if stride == 2:
            self.conv1 = SparseConvDown(inplanes, planes, out_capacity, 3)
        else:
            self.conv1 = SparseConv(inplanes, planes)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes)
        self.norm2 = MaskedBatchNorm(planes)
        self.downsample = None
        if not (stride == 1 and inplanes == planes):
            conv = (SparseConvDown(inplanes, planes, out_capacity, 1)
                    if stride == 2 else SparseConv(inplanes, planes, 1))
            self.downsample = nn.ModuleList([conv, MaskedBatchNorm(planes)])

    def forward(self, grid: VoxelGrid) -> VoxelGrid:
        out_grid = None
        if self.stride == 2:
            out_grid = downsample_grid(grid, self.out_capacity)
            out = self.conv1(grid, out_grid)
        else:
            out = self.conv1(grid)
        f = F.relu(self.norm1(out.features, out.valid))
        out2 = self.conv2(out.replace(features=f))
        f2 = self.norm2(out2.features, out2.valid)
        if self.downsample is not None:
            conv, norm = self.downsample
            ds = conv(grid, out_grid) if self.stride == 2 else conv(grid)
            skip = norm(ds.features, ds.valid)
        else:
            skip = grid.features
        f2 = F.relu(f2 + skip)
        return out2.replace(features=torch.where(out2.valid[..., None], f2,
                                                 0.0))


class SparseResNet(nn.Module):
    ARCH = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}

    def __init__(self, in_channels: int, depth: int, inplanes: int,
                 num_stages: int, stage_capacities: Sequence[int]):
        super().__init__()
        stage_blocks = self.ARCH[depth][:num_stages]
        self.conv1 = SparseConvDown(in_channels, inplanes,
                                    stage_capacities[0], 3)
        self.norm1 = MaskedBatchNorm(inplanes)
        cin = inplanes
        for i, nblocks in enumerate(stage_blocks):
            planes = inplanes * 2 ** i
            blocks = [SparseBasicBlock(cin, planes, 2,
                                       stage_capacities[i + 1])]
            cin = planes
            blocks += [SparseBasicBlock(cin, planes)
                       for _ in range(1, nblocks)]
            self.add_module(f"layer{i + 1}", nn.ModuleList(blocks))
        self.num_stages = len(stage_blocks)

    def forward(self, grid):
        x = self.conv1(grid)
        x = x.replace(features=F.relu(self.norm1(x.features, x.valid)))
        outs = []
        for i in range(self.num_stages):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x)
            outs.append(x)
        return outs


class FPNUpBlock(nn.Sequential):
    def __init__(self, cin: int, cout: int):
        super().__init__(SparseConvTranspose(cin, cout),
                         MaskedBatchNorm(cout), nn.ELU(),
                         SparseConv(cout, cout), MaskedBatchNorm(cout))

    def forward(self, coarse, fine_sites):
        up_conv, up_norm, elu, conv, norm = self
        up = up_conv(coarse, fine_sites)
        up = up.replace(features=elu(up_norm(up.features, up.valid)))
        out = conv(up)
        return out.replace(features=elu(norm(out.features, out.valid)))


class FPNOutBlock(nn.Sequential):
    def __init__(self, cin: int, cout: int):
        super().__init__(SparseConv(cin, cout), MaskedBatchNorm(cout),
                         nn.ELU())

    def forward(self, grid):
        conv, norm, elu = self
        out = conv(grid)
        return out.replace(features=elu(norm(out.features, out.valid)))
