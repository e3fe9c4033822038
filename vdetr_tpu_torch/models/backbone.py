"""Sparse ResNet backbone and FPN neck (torch counterpart of
`vdetr_tpu/models/backbone.py`; reference models/mink_resnet.py and
models/model_vdetr.py:139-193).

Modules operate on `VoxelGrid`s. Parameter names follow the reference
MinkowskiEngine stack (`conv1.kernel`, `norm1.bn.weight`,
`downsample.0.kernel`, `up_block_3.0.kernel`, ...); kernels keep the JAX
package's (K, C_in, C_out) layout with z-fastest offsets.

`compute_dtype` (None or torch.bfloat16, the JAX package's
`compute_dtype="bfloat16"`): every conv multiplies bf16 features by bf16
weights into float32, and the features between convs are stored in bf16
(`_store`, JAX `backbone.py:32-39`); the norms take their statistics in
float32 from them, and skip adds run in float32 before the store.

`conv_route` ("keyed" or "mapped", `ops/sparse_conv.py`) picks how the
3^3 convs run; the weights are the same on both routes. On the mapped
route each stage's first block attaches its level's neighbour map once,
on the downsampled grid (JAX `backbone.py:127-142`), built in one launch
with its stride-2 conv's map; every later conv on those sites shares it,
the FPN's included, whose grids are the encoder grids' `replace`s.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vdetr_tpu_torch.models.norm import MaskedBatchNorm, MaskedInstanceNorm
from vdetr_tpu_torch.ops.sparse_conv import (
    attach_kernel_map,
    attach_kernel_maps,
    check_route,
    sparse_conv,
    sparse_conv_down,
    sparse_conv_transpose,
    sparse_conv_transpose_generative,
)
from vdetr_tpu_torch.ops.voxelize import VoxelGrid, downsample_grid


def _store(f, compute_dtype):
    """Backbone-resident storage: the features between convs in
    `compute_dtype` (None: as they are)."""
    return f if compute_dtype is None else f.to(compute_dtype)


class SparseConv(nn.Module):
    """Submanifold (stride-1) conv, kernel (k^3, C_in, C_out), no bias. On
    the mapped route a 3^3 conv whose grid carries no neighbour map yet
    attaches one (as JAX's `sparse_conv` builds one on the fly); in the
    published model every grid arrives with its level's map."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, conv_route: str = "keyed",
                 compute_dtype=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv_route = check_route(conv_route)
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(
            torch.empty(kernel_size ** 3, in_channels, out_channels))

    def forward(self, grid: VoxelGrid) -> VoxelGrid:
        if (self.conv_route == "mapped" and self.kernel_size == 3
                and grid.nbr_idx is None):
            grid = attach_kernel_map(grid)
        return sparse_conv(grid, self.kernel, self.kernel_size,
                           self.compute_dtype)


class SparseConvDown(nn.Module):
    """Stride-2 conv (kernel 3, or kernel 1 for the ResNet downsample)."""

    def __init__(self, in_channels: int, out_channels: int,
                 out_capacity: int, kernel_size: int = 3,
                 conv_route: str = "keyed", compute_dtype=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.out_capacity = out_capacity
        self.conv_route = check_route(conv_route)
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(
            torch.empty(kernel_size ** 3, in_channels, out_channels))

    def forward(self, grid: VoxelGrid, out_grid: Optional[VoxelGrid] = None,
                nbr=None) -> VoxelGrid:
        return sparse_conv_down(grid, self.kernel, self.out_capacity,
                                self.kernel_size, out_grid=out_grid,
                                route=self.conv_route, nbr=nbr,
                                compute_dtype=self.compute_dtype)


class SparseConvTranspose(nn.Module):
    """Kernel-2 stride-2 transpose conv evaluated at the skip grid, or
    generative (all 8 children) when no fine sites are given."""

    def __init__(self, in_channels: int, out_channels: int,
                 generative_capacity: Optional[int] = None,
                 compute_dtype=None):
        super().__init__()
        self.generative_capacity = generative_capacity
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.empty(8, in_channels, out_channels))

    def forward(self, coarse: VoxelGrid,
                fine_sites: Optional[VoxelGrid] = None) -> VoxelGrid:
        if fine_sites is not None:
            return sparse_conv_transpose(coarse, fine_sites, self.kernel,
                                         self.compute_dtype)
        return sparse_conv_transpose_generative(
            coarse, self.kernel, self.generative_capacity,
            self.compute_dtype)


class SparseBasicBlock(nn.Module):
    """ResNet BasicBlock on voxels: conv-bn-relu-conv-bn + skip, relu
    (MinkowskiEngine.modules.resnet_block.BasicBlock)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 out_capacity: Optional[int] = None,
                 conv_route: str = "keyed", compute_dtype=None):
        super().__init__()
        cd = compute_dtype
        self.stride = stride
        self.out_capacity = out_capacity
        self.conv_route = conv_route
        self.compute_dtype = cd
        if stride == 2:
            self.conv1 = SparseConvDown(inplanes, planes, out_capacity, 3,
                                        conv_route, cd)
        else:
            self.conv1 = SparseConv(inplanes, planes, conv_route=conv_route,
                                    compute_dtype=cd)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes, conv_route=conv_route,
                                compute_dtype=cd)
        self.norm2 = MaskedBatchNorm(planes)
        self.downsample = _downsample(inplanes, planes, stride, out_capacity,
                                      cd)

    def forward(self, grid: VoxelGrid) -> VoxelGrid:
        out_grid = nbr = None
        if self.stride == 2:
            out_grid, nbr = _stride2_sites(grid, self.out_capacity,
                                           self.conv_route)
            out = self.conv1(grid, out_grid, nbr)
        else:
            out = self.conv1(grid)
        f = _store(F.relu(self.norm1(out.features, out.valid)),
                   self.compute_dtype)
        out2 = self.conv2(out.replace(features=f))
        f2 = self.norm2(out2.features, out2.valid)
        return _join(out2, f2, grid, out_grid, self.downsample,
                     self.stride, self.compute_dtype)


class SparseBottleneck(nn.Module):
    """ResNet Bottleneck on voxels: 1x1 -> 3x3 (the stride on conv2) ->
    1x1 to 4x the width, each conv with a norm, plus the skip, relu
    (MinkowskiEngine.modules.resnet_block.Bottleneck; JAX
    `backbone.py:176-246`; the reference's depths 50/101/152). The 1x1
    convs are torch matmuls over the rows, the 3x3 conv runs on kernel A
    (keyed route) or H (mapped route)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 out_capacity: Optional[int] = None,
                 conv_route: str = "keyed", compute_dtype=None):
        super().__init__()
        cd = compute_dtype
        out_ch = planes * self.expansion
        self.stride = stride
        self.out_capacity = out_capacity
        self.conv_route = conv_route
        self.compute_dtype = cd
        self.conv1 = SparseConv(inplanes, planes, 1, compute_dtype=cd)
        self.norm1 = MaskedBatchNorm(planes)
        if stride == 2:
            self.conv2 = SparseConvDown(planes, planes, out_capacity, 3,
                                        conv_route, cd)
        else:
            self.conv2 = SparseConv(planes, planes, conv_route=conv_route,
                                    compute_dtype=cd)
        self.norm2 = MaskedBatchNorm(planes)
        self.conv3 = SparseConv(planes, out_ch, 1, compute_dtype=cd)
        self.norm3 = MaskedBatchNorm(out_ch)
        self.downsample = _downsample(inplanes, out_ch, stride, out_capacity,
                                      cd)

    def forward(self, grid: VoxelGrid) -> VoxelGrid:
        cd = self.compute_dtype
        out = self.conv1(grid)
        out = out.replace(features=_store(
            F.relu(self.norm1(out.features, out.valid)), cd))
        out_grid = None
        if self.stride == 2:
            out_grid, nbr = _stride2_sites(grid, self.out_capacity,
                                           self.conv_route)
            out = self.conv2(out, out_grid, nbr)
        else:
            out = self.conv2(out)
        out = self.conv3(out.replace(features=_store(
            F.relu(self.norm2(out.features, out.valid)), cd)))
        f3 = self.norm3(out.features, out.valid)
        return _join(out, f3, grid, out_grid, self.downsample, self.stride,
                     cd)


def _downsample(inplanes: int, out_ch: int, stride: int, out_capacity,
                compute_dtype):
    """A block's skip branch, a 1x1 conv (stride 2 where the block's is)
    and a norm, where the block changes the sites or the width; else
    None."""
    if stride == 1 and inplanes == out_ch:
        return None
    conv = (SparseConvDown(inplanes, out_ch, out_capacity, 1,
                           compute_dtype=compute_dtype) if stride == 2
            else SparseConv(inplanes, out_ch, 1, compute_dtype=compute_dtype))
    return nn.ModuleList([conv, MaskedBatchNorm(out_ch)])


def _stride2_sites(grid: VoxelGrid, out_capacity: int, conv_route: str):
    """(out_grid, nbr) of a block's stride-2 step: one site computation
    shared by its strided conv and the downsample; on the mapped route
    also the strided conv's map and the new level's one neighbour map,
    which every later conv on these sites shares, built in one launch
    (nbr None on the keyed route)."""
    out_grid = downsample_grid(grid, out_capacity)
    if conv_route == "mapped":
        return attach_kernel_maps(grid, out_grid)
    return out_grid, None


def _join(out: VoxelGrid, f, grid: VoxelGrid, out_grid, downsample,
          stride: int, compute_dtype) -> VoxelGrid:
    """A block's end: relu(f + skip) in float32 at the valid rows of
    `out`, stored in `compute_dtype`; the skip is the downsample branch
    of the block's input `grid` where there is one, else `grid`'s
    features."""
    if downsample is not None:
        conv, norm = downsample
        ds = conv(grid, out_grid) if stride == 2 else conv(grid)
        skip = norm(ds.features, ds.valid)
    else:
        skip = grid.features
    f = F.relu(f + skip.to(f.dtype))
    return out.replace(features=torch.where(
        out.valid[..., None], _store(f, compute_dtype), 0.0))


class SparseResNet(nn.Module):
    """MinkResNet (reference models/mink_resnet.py:8-102): stem conv k3 s2
    + norm + relu, then `num_stages` stages of blocks, each stride 2.
    Returns all stage outputs. Depths 18 and 34 (BasicBlock), 50, 101 and
    152 (Bottleneck, 4x wider stage outputs). `conv_route` is the port's
    counterpart of the JAX package's choice between the keyed TPU kernel
    and the mapped gather path (its backend, or
    VDETR_DISABLE_WINDOW_KERNEL): "keyed" or "mapped"."""

    ARCH = {
        18: (SparseBasicBlock, (2, 2, 2, 2)),
        34: (SparseBasicBlock, (3, 4, 6, 3)),
        50: (SparseBottleneck, (3, 4, 6, 3)),
        101: (SparseBottleneck, (3, 4, 23, 3)),
        152: (SparseBottleneck, (3, 8, 36, 3)),
    }

    def __init__(self, in_channels: int, depth: int = 34, inplanes: int = 64,
                 num_stages: int = 4, stem_bn: bool = True,
                 stage_capacities: Sequence[int] = (65536, 32768, 16384,
                                                    8192, 4096),
                 conv_route: str = "keyed", compute_dtype=None):
        super().__init__()
        if depth not in self.ARCH:
            raise KeyError(f"unsupported sparse resnet depth {depth}")
        block_cls, stage_blocks = self.ARCH[depth]
        stage_blocks = stage_blocks[:num_stages]
        self.compute_dtype = compute_dtype
        self.conv1 = SparseConvDown(in_channels, inplanes,
                                    stage_capacities[0], 3, conv_route,
                                    compute_dtype)
        self.norm1 = (MaskedBatchNorm(inplanes) if stem_bn
                      else MaskedInstanceNorm(inplanes))
        cin = inplanes
        for i, nblocks in enumerate(stage_blocks):
            planes = inplanes * 2 ** i
            blocks = [block_cls(cin, planes, 2, stage_capacities[i + 1],
                                conv_route, compute_dtype)]
            cin = planes * block_cls.expansion
            blocks += [block_cls(cin, planes, conv_route=conv_route,
                                 compute_dtype=compute_dtype)
                       for _ in range(1, nblocks)]
            self.add_module(f"layer{i + 1}", nn.ModuleList(blocks))
        self.num_stages = len(stage_blocks)

    def forward(self, grid: VoxelGrid):
        x = self.conv1(grid)
        x = x.replace(features=_store(F.relu(self.norm1(x.features,
                                                        x.valid)),
                                      self.compute_dtype))
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
                 conv_route: str = "keyed", compute_dtype=None):
        super().__init__(
            SparseConvTranspose(in_channels, out_channels,
                                None if woexpand_conv else generative_capacity,
                                compute_dtype),
            MaskedBatchNorm(out_channels),
            nn.ELU(),
            SparseConv(out_channels, out_channels, conv_route=conv_route,
                       compute_dtype=compute_dtype),
            MaskedBatchNorm(out_channels),
        )
        self.woexpand_conv = woexpand_conv
        self.compute_dtype = compute_dtype

    def forward(self, coarse: VoxelGrid, fine_sites: VoxelGrid) -> VoxelGrid:
        up_conv, up_norm, elu, conv, norm = self
        cd = self.compute_dtype
        up = up_conv(coarse, fine_sites if self.woexpand_conv else None)
        up = up.replace(features=_store(elu(up_norm(up.features, up.valid)),
                                        cd))
        out = conv(up)
        return out.replace(features=_store(elu(norm(out.features,
                                                    out.valid)), cd))


class FPNOutBlock(nn.Sequential):
    """conv k3 + BN + ELU to `enc_dim` (reference model_vdetr.py:139-144)."""

    def __init__(self, in_channels: int, out_channels: int,
                 conv_route: str = "keyed", compute_dtype=None):
        super().__init__(SparseConv(in_channels, out_channels,
                                    conv_route=conv_route,
                                    compute_dtype=compute_dtype),
                         MaskedBatchNorm(out_channels), nn.ELU())

    def forward(self, grid: VoxelGrid) -> VoxelGrid:
        conv, norm, elu = self
        out = conv(grid)
        return out.replace(features=elu(norm(out.features, out.valid)))
