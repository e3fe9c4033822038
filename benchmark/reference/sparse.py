"""Voxel grids and sparse convolutions, plain (frozen copy of the plain
paths of `vdetr_tpu_torch/ops/voxelize.py`, `ops/map_kernel.py`,
`ops/sparse_conv.py` and `ops/sparse_conv_kernel.py`, keyed route, float32).

Every 3^3 conv builds its exact neighbour map with one `searchsorted`
lookup and sums a row gather times the offset's weights over the 27
offsets. Its gradients are the same sums transposed: dFeats a
scatter-add of dout @ W[k]^T into each offset's neighbour rows, dW[k]
the gathered rows transposed times dout. The map is saved for the
backward; the gathered rows are not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

KEY_SENTINEL = 2 ** 31 - 1


@dataclasses.dataclass
class VoxelGrid:
    coords: torch.Tensor      # (B, V, 3) int32, level units, 0 where invalid
    keys: torch.Tensor        # (B, V) int32 ascending, SENTINEL where invalid
    features: Optional[torch.Tensor]  # (B, V, C)
    valid: torch.Tensor       # (B, V) bool
    origin: torch.Tensor      # (B, 3) int32
    stride: int
    extent: Tuple[int, int, int]
    voxel_size: float

    def world_xyz(self):
        base = self.coords * self.stride + self.origin[:, None, :]
        return base.to(torch.float32) * self.voxel_size

    def replace(self, **kw) -> "VoxelGrid":
        return dataclasses.replace(self, **kw)


def pack_keys(coords, extent):
    gx, gy, gz = extent
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    inb = (x >= 0) & (x < gx) & (y >= 0) & (y < gy) & (z >= 0) & (z < gz)
    key = (x * gy + y) * gz + z
    return torch.where(inb, key, KEY_SENTINEL).to(torch.int32)


def unpack_keys(keys, extent):
    _, gy, gz = extent
    z = keys % gz
    y = (keys // gz) % gy
    x = keys // (gy * gz)
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def lookup(keys_sorted, query_keys):
    """(B, M) row of each query key in the sorted keys, V for a miss."""
    V = keys_sorted.shape[-1]
    pos = torch.searchsorted(keys_sorted, query_keys)
    pos_c = pos.clamp(max=V - 1)
    hit = ((keys_sorted.gather(-1, pos_c) == query_keys)
           & (query_keys != KEY_SENTINEL))
    return torch.where(hit, pos_c, V)


def gather_rows(feats, idx):
    """feats (B, V, C) rows at idx (B, M) in [0, V]; index V reads 0."""
    B, V, C = feats.shape
    ext = torch.cat([feats, feats.new_zeros(B, 1, C)], dim=1)
    return ext.gather(1, idx[..., None].expand(-1, -1, C))


def _compact_unique(keys, capacity, feats=None):
    B, N = keys.shape
    sk, perm = torch.sort(keys, dim=1, stable=True)
    head = sk != KEY_SENTINEL
    head[:, 1:] &= sk[:, 1:] != sk[:, :-1]
    rank = torch.cumsum(head, dim=1) - 1
    dest = torch.where(head & (rank < capacity), rank, capacity)
    out_keys = torch.full((B, capacity + 1), KEY_SENTINEL, dtype=torch.int32,
                          device=keys.device)
    out_keys.scatter_(1, dest, sk)
    out_keys[:, capacity] = KEY_SENTINEL
    out_feats = None
    if feats is not None:
        C = feats.shape[-1]
        src = feats.gather(1, perm[..., None].expand(-1, -1, C))
        out_feats = feats.new_zeros(B, capacity + 1, C)
        out_feats.scatter_(1, dest[..., None].expand(-1, -1, C), src)
        out_feats = out_feats[:, :capacity].contiguous()
    return out_keys[:, :capacity].contiguous(), out_feats


def _coords_from_keys(keys, extent):
    valid = keys != KEY_SENTINEL
    coords = unpack_keys(torch.where(valid, keys, 0), extent)
    return torch.where(valid[..., None], coords, 0), valid


def voxelize(points, feats, point_valid, voxel_size: float, capacity: int,
             extent, align_stride: int = 32) -> VoxelGrid:
    """Stride-1 grid of the points: coordinates floor(points * r), r the
    float32 reciprocal of the voxel size; the lowest point index wins a
    voxel; past `capacity` the largest keys are dropped."""
    inv = (1.0 / torch.tensor(voxel_size, dtype=torch.float32)).item()
    coords_raw = torch.floor(points * inv).to(torch.int32)
    masked = torch.where(point_valid[..., None], coords_raw, 1 << 30)
    mn = masked.min(dim=1).values
    origin = torch.div(mn, align_stride, rounding_mode="floor") * align_stride
    origin = torch.where(point_valid.any(dim=1, keepdim=True), origin, 0)
    origin = origin.to(torch.int32)
    c = coords_raw - origin[:, None, :]
    keys = torch.where(point_valid, pack_keys(c, extent), KEY_SENTINEL)
    out_keys, out_feats = _compact_unique(keys, capacity, feats)
    coords, valid = _coords_from_keys(out_keys, extent)
    return VoxelGrid(coords=coords, keys=out_keys, features=out_feats,
                     valid=valid, origin=origin, stride=1,
                     extent=tuple(extent), voxel_size=voxel_size)


def downsample_grid(grid: VoxelGrid, out_capacity: int) -> VoxelGrid:
    gx, gy, gz = grid.extent
    child_extent = ((gx + 1) // 2, (gy + 1) // 2, (gz + 1) // 2)
    keys = torch.where(grid.valid, pack_keys(grid.coords // 2, child_extent),
                       KEY_SENTINEL)
    out_keys, _ = _compact_unique(keys, out_capacity)
    coords, valid = _coords_from_keys(out_keys, child_extent)
    return VoxelGrid(coords=coords, keys=out_keys, features=None,
                     valid=valid, origin=grid.origin, stride=grid.stride * 2,
                     extent=child_extent, voxel_size=grid.voxel_size)


def kernel_offsets(device=None) -> torch.Tensor:
    """(27, 3) int32 offsets, x-major / z-fastest."""
    rng = range(-1, 2)
    return torch.tensor([(i, j, k) for i in rng for j in rng for k in rng],
                        dtype=torch.int32, device=device)


def neighbour_map(in_keys, q_coords, q_valid, extent):
    """(B, 27, V) int64 row of each query's 27 neighbours in the input
    table, V_in for a miss or an invalid query."""
    B, V, _ = q_coords.shape
    q = q_coords[:, None, :, :] + kernel_offsets(q_coords.device)[None, :,
                                                                   None, :]
    qk = torch.where(q_valid[:, None, :], pack_keys(q, extent), KEY_SENTINEL)
    return lookup(in_keys, qk.reshape(B, 27 * V)).reshape(B, 27, V)


def conv_plain(feats, nbr, weights):
    out = feats.new_zeros(nbr.shape[:1] + nbr.shape[2:] + weights.shape[-1:])
    for k in range(weights.shape[0]):
        out = out + torch.matmul(gather_rows(feats, nbr[:, k]), weights[k])
    return out


class _Conv3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, weights, nbr):
        ctx.save_for_backward(feats, weights, nbr)
        return conv_plain(feats, nbr, weights)

    @staticmethod
    def backward(ctx, dout):
        feats, weights, nbr = ctx.saved_tensors
        B, V_in, C = feats.shape
        Co = dout.shape[-1]
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            dfeats = dout.new_zeros(B, V_in + 1, C)  # row V_in: the misses
            for k in range(27):
                dfeats.scatter_add_(1, nbr[:, k, :, None].expand(-1, -1, C),
                                    torch.matmul(dout, weights[k].t()))
            dfeats = dfeats[:, :V_in]
        if ctx.needs_input_grad[1]:
            d = dout.reshape(-1, Co)
            dw = torch.stack([
                torch.matmul(gather_rows(feats, nbr[:, k]).reshape(-1, C).t(),
                             d) for k in range(27)])
        return dfeats, dw, None


def sparse_conv(grid: VoxelGrid, weights, kernel_size: int = 3) -> VoxelGrid:
    """Submanifold conv (output sites = input sites), kernel 1 or 3."""
    if kernel_size == 1:
        out = torch.matmul(grid.features, weights[0])
    else:
        nbr = neighbour_map(grid.keys, grid.coords, grid.valid, grid.extent)
        out = _Conv3.apply(grid.features, weights, nbr)
    return grid.replace(features=out * grid.valid[..., None])


def sparse_conv_down(grid: VoxelGrid, weights, out_grid: VoxelGrid,
                     kernel_size: int = 3) -> VoxelGrid:
    """Stride-2 conv onto `out_grid`'s sites: output o reads input sites
    2 o + d, d in {-1, 0, 1}^3 (kernel 3), or exactly 2 o (kernel 1)."""
    q0 = out_grid.coords * 2
    if kernel_size == 1:
        qk = torch.where(out_grid.valid, pack_keys(q0, grid.extent),
                         KEY_SENTINEL)
        out = torch.matmul(gather_rows(grid.features, lookup(grid.keys, qk)),
                           weights[0])
    else:
        nbr = neighbour_map(grid.keys, q0, out_grid.valid, grid.extent)
        out = _Conv3.apply(grid.features, weights, nbr)
    return out_grid.replace(features=out * out_grid.valid[..., None])


_CHILD_OFFSETS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def child_rows(coarse: VoxelGrid, fine_sites: VoxelGrid):
    offs = torch.tensor(_CHILD_OFFSETS, dtype=torch.int32,
                        device=coarse.coords.device)
    cand = coarse.coords[:, None, :, :] * 2 + offs[None, :, None, :]
    ck = torch.where(coarse.valid[:, None, :],
                     pack_keys(cand, fine_sites.extent), KEY_SENTINEL)
    B, V = coarse.valid.shape
    return lookup(fine_sites.keys, ck.reshape(B, 8 * V)).reshape(B, 8, V)


class _ParentGather(torch.autograd.Function):
    """Gather of each fine site's parent row; the backward sums each
    coarse row's children in slot order (a fixed order)."""

    @staticmethod
    def forward(ctx, feats, parent, coarse, fine_sites):
        ctx.grids = (coarse, fine_sites)
        return gather_rows(feats, parent)

    @staticmethod
    def backward(ctx, dx):
        children = child_rows(*ctx.grids)
        B, M, C = dx.shape
        ext = torch.cat([dx, dx.new_zeros(B, 1, C)], dim=1)
        dfeats = None
        for s in range(8):
            part = ext.gather(1, children[:, s, :, None].expand(-1, -1, C))
            dfeats = part if dfeats is None else dfeats + part
        return dfeats, None, None, None


def sparse_conv_transpose(coarse: VoxelGrid, fine_sites: VoxelGrid,
                          weights) -> VoxelGrid:
    """Kernel-2 stride-2 transpose conv at the given fine sites: fine site
    f reads its parent floor(f / 2) with the weights of slot f - 2 parent."""
    parent = fine_sites.coords // 2
    pk = torch.where(fine_sites.valid, pack_keys(parent, coarse.extent),
                     KEY_SENTINEL)
    x = _ParentGather.apply(coarse.features, lookup(coarse.keys, pk),
                            coarse.replace(features=None),
                            fine_sites.replace(features=None))
    rel = fine_sites.coords - parent * 2
    slot = (rel[..., 0] * 2 + rel[..., 1]) * 2 + rel[..., 2]
    out = x.new_zeros(x.shape[:-1] + (weights.shape[-1],))
    for kk in range(8):
        xm = torch.where((slot == kk)[..., None], x, 0.0)
        out = out + torch.matmul(xm, weights[kk])
    return fine_sites.replace(features=out * fine_sites.valid[..., None])
