"""Sparse ResNet backbone and FPN neck (torch counterpart of
`vdetr_tpu/models/backbone.py`; reference models/mink_resnet.py and
models/model_vdetr.py:139-193).

Modules operate on `VoxelGrid`s. Parameter names follow the reference
MinkowskiEngine stack (`conv1.kernel`, `norm1.bn.weight`,
`downsample.0.kernel`, `up_block_3.0.kernel`, ...); kernels keep the JAX
package's (K, C_in, C_out) layout with z-fastest offsets.

`conv_route` ("keyed" or "mapped", `ops/sparse_conv.py`) picks how the
3^3 convs run; the weights are the same on both routes. On the mapped
route each stage's first block attaches its level's neighbour map once,
on the downsampled grid (JAX `backbone.py:127-142`); every later conv on
those sites shares it, the FPN's included, whose grids are the encoder
grids' `replace`s.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vdetr_tpu_torch.models.norm import MaskedBatchNorm, MaskedInstanceNorm
from vdetr_tpu_torch.ops.sparse_conv import (
    attach_kernel_map,
    check_route,
    sparse_conv,
    sparse_conv_down,
    sparse_conv_transpose,
    sparse_conv_transpose_generative,
)
from vdetr_tpu_torch.ops.voxelize import VoxelGrid, downsample_grid


class SparseConv(nn.Module):
    """Submanifold (stride-1) conv, kernel (k^3, C_in, C_out), no bias. On
    the mapped route a 3^3 conv whose grid carries no neighbour map yet
    attaches one (as JAX's `sparse_conv` builds one on the fly); in the
    published model every grid arrives with its level's map."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, conv_route: str = "keyed"):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv_route = check_route(conv_route)
        self.kernel = nn.Parameter(
            torch.empty(kernel_size ** 3, in_channels, out_channels))

    def forward(self, grid: VoxelGrid) -> VoxelGrid:
        if (self.conv_route == "mapped" and self.kernel_size == 3
                and grid.nbr_idx is None):
            grid = attach_kernel_map(grid)
        return sparse_conv(grid, self.kernel, self.kernel_size)


class SparseConvDown(nn.Module):
    """Stride-2 conv (kernel 3, or kernel 1 for the ResNet downsample)."""

    def __init__(self, in_channels: int, out_channels: int,
                 out_capacity: int, kernel_size: int = 3,
                 conv_route: str = "keyed"):
        super().__init__()
        self.kernel_size = kernel_size
        self.out_capacity = out_capacity
        self.conv_route = check_route(conv_route)
        self.kernel = nn.Parameter(
            torch.empty(kernel_size ** 3, in_channels, out_channels))

    def forward(self, grid: VoxelGrid,
                out_grid: Optional[VoxelGrid] = None) -> VoxelGrid:
        return sparse_conv_down(grid, self.kernel, self.out_capacity,
                                self.kernel_size, out_grid=out_grid,
                                route=self.conv_route)


class SparseConvTranspose(nn.Module):
    """Kernel-2 stride-2 transpose conv evaluated at the skip grid, or
    generative (all 8 children) when no fine sites are given."""

    def __init__(self, in_channels: int, out_channels: int,
                 generative_capacity: Optional[int] = None):
        super().__init__()
        self.generative_capacity = generative_capacity
        self.kernel = nn.Parameter(torch.empty(8, in_channels, out_channels))

    def forward(self, coarse: VoxelGrid,
                fine_sites: Optional[VoxelGrid] = None) -> VoxelGrid:
        if fine_sites is not None:
            return sparse_conv_transpose(coarse, fine_sites, self.kernel)
        return sparse_conv_transpose_generative(coarse, self.kernel,
                                                self.generative_capacity)


class SparseBasicBlock(nn.Module):
    """ResNet BasicBlock on voxels: conv-bn-relu-conv-bn + skip, relu
    (MinkowskiEngine.modules.resnet_block.BasicBlock)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 out_capacity: Optional[int] = None,
                 conv_route: str = "keyed"):
        super().__init__()
        self.stride = stride
        self.out_capacity = out_capacity
        self.conv_route = conv_route
        if stride == 2:
            self.conv1 = SparseConvDown(inplanes, planes, out_capacity, 3,
                                        conv_route)
        else:
            self.conv1 = SparseConv(inplanes, planes, conv_route=conv_route)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes, conv_route=conv_route)
        self.norm2 = MaskedBatchNorm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            ds = (SparseConvDown(inplanes, planes, out_capacity, 1)
                  if stride == 2 else SparseConv(inplanes, planes, 1))
            self.downsample = nn.ModuleList([ds, MaskedBatchNorm(planes)])

    def forward(self, grid: VoxelGrid) -> VoxelGrid:
        out_grid = None
        if self.stride == 2:
            # one site computation shared by conv1 and the downsample; on
            # the mapped route also the level's one neighbour map, which
            # conv2 and every later block on these sites share
            out_grid = downsample_grid(grid, self.out_capacity)
            if self.conv_route == "mapped":
                out_grid = attach_kernel_map(out_grid)
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
        f = F.relu(f2 + skip)
        return out2.replace(features=torch.where(out2.valid[..., None], f,
                                                 0.0))


class SparseResNet(nn.Module):
    """MinkResNet (reference models/mink_resnet.py:8-102): stem conv k3 s2
    + norm + relu, then `num_stages` stages of BasicBlocks, each stride 2.
    Returns all stage outputs. Depths 18 and 34 (BasicBlock). `conv_route`
    is the port's counterpart of the JAX package's choice between the
    keyed TPU kernel and the mapped gather path (its backend, or
    VDETR_DISABLE_WINDOW_KERNEL): "keyed" or "mapped"."""

    ARCH = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}

    def __init__(self, in_channels: int, depth: int = 34, inplanes: int = 64,
                 num_stages: int = 4, stem_bn: bool = True,
                 stage_capacities: Sequence[int] = (65536, 32768, 16384,
                                                    8192, 4096),
                 conv_route: str = "keyed"):
        super().__init__()
        if depth not in self.ARCH:
            raise NotImplementedError(
                f"sparse resnet depth {depth}: only BasicBlock depths "
                f"{sorted(self.ARCH)} are ported")
        stage_blocks = self.ARCH[depth][:num_stages]
        self.conv1 = SparseConvDown(in_channels, inplanes,
                                    stage_capacities[0], 3, conv_route)
        self.norm1 = (MaskedBatchNorm(inplanes) if stem_bn
                      else MaskedInstanceNorm(inplanes))
        cin = inplanes
        for i, nblocks in enumerate(stage_blocks):
            planes = inplanes * 2 ** i
            blocks = [SparseBasicBlock(cin, planes, 2, stage_capacities[i + 1],
                                       conv_route)]
            blocks += [SparseBasicBlock(planes, planes, conv_route=conv_route)
                       for _ in range(1, nblocks)]
            self.add_module(f"layer{i + 1}", nn.ModuleList(blocks))
            cin = planes
        self.num_stages = len(stage_blocks)

    def forward(self, grid: VoxelGrid):
        x = self.conv1(grid)
        x = x.replace(features=F.relu(self.norm1(x.features, x.valid)))
        outs = []
        for i in range(self.num_stages):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x)
            outs.append(x)
        return outs


class FPNUpBlock(nn.Sequential):
    """Transpose conv + BN + ELU + conv k3 + BN + ELU (reference
    model_vdetr.py:146-176); indices 0..4 as in the reference."""

    def __init__(self, in_channels: int, out_channels: int,
                 woexpand_conv: bool = True,
                 generative_capacity: Optional[int] = None,
                 conv_route: str = "keyed"):
        super().__init__(
            SparseConvTranspose(in_channels, out_channels,
                                None if woexpand_conv else generative_capacity),
            MaskedBatchNorm(out_channels),
            nn.ELU(),
            SparseConv(out_channels, out_channels, conv_route=conv_route),
            MaskedBatchNorm(out_channels),
        )
        self.woexpand_conv = woexpand_conv

    def forward(self, coarse: VoxelGrid, fine_sites: VoxelGrid) -> VoxelGrid:
        up_conv, up_norm, elu, conv, norm = self
        up = up_conv(coarse, fine_sites if self.woexpand_conv else None)
        up = up.replace(features=elu(up_norm(up.features, up.valid)))
        out = conv(up)
        return out.replace(features=elu(norm(out.features, out.valid)))


class FPNOutBlock(nn.Sequential):
    """conv k3 + BN + ELU to `enc_dim` (reference model_vdetr.py:139-144)."""

    def __init__(self, in_channels: int, out_channels: int,
                 conv_route: str = "keyed"):
        super().__init__(SparseConv(in_channels, out_channels,
                                    conv_route=conv_route),
                         MaskedBatchNorm(out_channels), nn.ELU())

    def forward(self, grid: VoxelGrid) -> VoxelGrid:
        conv, norm, elu = self
        out = conv(grid)
        return out.replace(features=elu(norm(out.features, out.valid)))
