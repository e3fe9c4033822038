"""Sparse 3D convolutions over `VoxelGrid`s (torch counterpart of
`vdetr_tpu/ops/sparse_conv.py:293-548`; reference: MinkowskiEngine).

Weights are (K, C_in, C_out) with offsets x-major / z-fastest. A 3^3
conv (submanifold or stride 2, the 3-channel stem included) takes one of
two routes, each a Hopper kernel with an autograd Function:
- keyed (the default): kernel A resolves every neighbour inside the conv
  by binary search (`ops/sparse_conv_keyed.py`);
- mapped: the exact neighbour map is built once by kernel G
  (`ops/map_kernel.py`) and kernel H convolves over it
  (`ops/sparse_conv_kernel.py`). A submanifold conv runs it when its grid
  carries a map (`attach_kernel_map`, MinkowskiEngine's kernel-map
  cache); a stride-2 conv on this route builds its own map.
The 1x1 downsample and the kernel-2 transpose convs are plain torch, as
they are plain XLA in the JAX package: a lookup, a row gather and
`torch.matmul`, differentiated by autograd.
"""

from __future__ import annotations

import torch

from vdetr_tpu_torch.ops.map_kernel import kernel_map
from vdetr_tpu_torch.ops.sparse_conv_keyed import keyed_conv_ad
from vdetr_tpu_torch.ops.sparse_conv_kernel import mapped_conv_ad
from vdetr_tpu_torch.ops.voxelize import (KEY_SENTINEL, VoxelGrid,
                                          downsample_grid, gather_rows,
                                          lookup, pack_keys,
                                          upsample_candidates)


CONV_ROUTES = ("keyed", "mapped")


def check_route(route: str) -> str:
    if route not in CONV_ROUTES:
        raise ValueError(f"conv route {route!r}: want one of {CONV_ROUTES}")
    return route


def attach_kernel_map(grid: VoxelGrid) -> VoxelGrid:
    """`grid` with the (B, 27, V) neighbour map of the 3^3 stencil on its
    own sites attached (the JAX package's `attach_kernel_map` off the TPU):
    every 3^3 `sparse_conv` on these sites then runs over it."""
    return grid.replace(nbr_idx=kernel_map(grid.keys, grid.coords,
                                           grid.valid, grid.extent))


def sparse_conv(grid: VoxelGrid, weights, kernel_size: int = 3) -> VoxelGrid:
    """Submanifold (stride-1) conv: output sites == input sites.
    weights: (kernel_size^3, C_in, C_out). A 3^3 conv runs over the
    grid's neighbour map when one is attached (the mapped route), else
    the keyed kernel."""
    if kernel_size == 1:
        out = torch.matmul(grid.features, weights[0])
    elif kernel_size == 3 and grid.nbr_idx is not None:
        out = mapped_conv_ad(grid.features, grid.nbr_idx, weights,
                             submanifold=True)
    elif kernel_size == 3:
        out = keyed_conv_ad(grid.features, grid.keys, grid.coords,
                            grid.valid, grid.extent, weights,
                            submanifold=True)
    else:
        raise ValueError(f"unsupported kernel size {kernel_size}")
    return grid.replace(features=out * grid.valid[..., None])


def sparse_conv_down(grid: VoxelGrid, weights, out_capacity: int = 0,
                     kernel_size: int = 3, out_grid: VoxelGrid = None,
                     route: str = "keyed") -> VoxelGrid:
    """Stride-2 conv. Output sites = unique(floor(c / 2)); output o reads
    input sites 2*o + d, d in {-1,0,1}^3 (kernel 3), or exactly 2*o
    (kernel 1, the ResNet downsample branch). Pass `out_grid` to share
    the site computation between a block's two strided convs. `route`
    (a 3^3 conv): "keyed", or "mapped", which builds the stride-2 map of
    the queries 2*o and convolves over it."""
    check_route(route)
    if out_grid is None:
        out_grid = downsample_grid(grid, out_capacity)
    q0 = out_grid.coords * 2
    if kernel_size == 1:
        qk = torch.where(out_grid.valid, pack_keys(q0, grid.extent),
                         KEY_SENTINEL)
        x = gather_rows(grid.features, lookup(grid.keys, qk))
        out = torch.matmul(x, weights[0])
    elif kernel_size == 3 and route == "mapped":
        nbr = kernel_map(grid.keys, q0, out_grid.valid, grid.extent)
        out = mapped_conv_ad(grid.features, nbr, weights, submanifold=False)
    elif kernel_size == 3:
        out = keyed_conv_ad(grid.features, grid.keys, q0, out_grid.valid,
                            grid.extent, weights, submanifold=False)
    else:
        raise ValueError(f"unsupported kernel size {kernel_size}")
    return out_grid.replace(features=out * out_grid.valid[..., None])


def sparse_conv_transpose(coarse: VoxelGrid, fine_sites: VoxelGrid,
                          weights) -> VoxelGrid:
    """Kernel-2 stride-2 transpose conv evaluated at given fine sites (the
    FPN skip grid). Fine site f has one coarse contributor floor(f / 2);
    its weight slot is the offset f - 2*floor(f / 2) in {0,1}^3,
    z-fastest, matching the (8, C_in, C_out) layout."""
    parent = fine_sites.coords // 2
    pk = torch.where(fine_sites.valid, pack_keys(parent, coarse.extent),
                     KEY_SENTINEL)
    x = gather_rows(coarse.features, lookup(coarse.keys, pk))
    rel = fine_sites.coords - parent * 2
    slot = (rel[..., 0] * 2 + rel[..., 1]) * 2 + rel[..., 2]
    out = x.new_zeros(x.shape[:-1] + (weights.shape[-1],))
    # one masked matmul per weight slot, as the JAX package does
    for kk in range(8):
        xm = torch.where((slot == kk)[..., None], x, 0.0)
        out = out + torch.matmul(xm, weights[kk])
    return fine_sites.replace(features=out * fine_sites.valid[..., None])


def sparse_conv_transpose_generative(coarse: VoxelGrid, weights,
                                     out_capacity: int) -> VoxelGrid:
    """Kernel-2 stride-2 generative transpose conv: the output sites are
    all 8 children of every coarse voxel."""
    fine = upsample_candidates(coarse, out_capacity)
    return sparse_conv_transpose(coarse, fine, weights)
