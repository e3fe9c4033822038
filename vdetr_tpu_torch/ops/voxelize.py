"""Batched, fixed-capacity voxelization (torch counterpart of
`vdetr_tpu/ops/voxelize.py:34-416`; reference: MinkowskiEngine's
coordinate manager, models/model_vdetr.py:250-261).

Per sample, voxels live in a padded array of static capacity V sorted by
a packed int32 key `(x * GY + y) * GZ + z`; empty slots carry
KEY_SENTINEL. Lookups are binary searches into the sorted keys.
Coordinates are shifted per sample so the minimum is >= 0, with the
shift aligned down to a multiple of the deepest stride so voxel grouping
parity across downsampling levels matches absolute coordinates.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

KEY_SENTINEL = 2 ** 31 - 1
DEFAULT_EXTENT = (2048, 2048, 511)


@dataclasses.dataclass
class VoxelGrid:
    """One level of a sparse voxel hierarchy (batched, padded).

    coords: (B, V, 3) int32, level-local units; invalid rows are 0.
    keys: (B, V) int32, ascending, invalid rows = KEY_SENTINEL.
    features: (B, V, C) float, invalid rows are 0.
    valid: (B, V) bool.
    origin: (B, 3) int32 base-lattice offset (multiple of the max stride).
    stride: base-lattice units per level unit.
    extent: (GX, GY, GZ) at this level.
    voxel_size: metres per base-lattice unit.
    """

    coords: torch.Tensor
    keys: torch.Tensor
    features: torch.Tensor
    valid: torch.Tensor
    origin: torch.Tensor
    stride: int
    extent: Tuple[int, int, int]
    voxel_size: float

    @property
    def capacity(self) -> int:
        return self.coords.shape[1]

    def world_xyz(self):
        """(B, V, 3) world coordinates of the voxel lattice points (the
        floor corner, reference model_vdetr.py:280)."""
        base = self.coords * self.stride + self.origin[:, None, :]
        return base.to(torch.float32) * self.voxel_size

    def replace(self, **kw) -> "VoxelGrid":
        return dataclasses.replace(self, **kw)


def pack_keys(coords, extent):
    """coords: (..., 3) int32 -> (...,) int32 key; out of range -> SENTINEL."""
    gx, gy, gz = extent
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    inb = (x >= 0) & (x < gx) & (y >= 0) & (y < gy) & (z >= 0) & (z < gz)
    key = (x * gy + y) * gz + z
    return torch.where(inb, key, KEY_SENTINEL).to(torch.int32)


def unpack_keys(keys, extent):
    """Inverse of pack_keys for in-range keys: (...,) -> (..., 3) int32."""
    _, gy, gz = extent
    z = keys % gz
    y = (keys // gz) % gy
    x = keys // (gy * gz)
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def lookup(keys_sorted, query_keys):
    """Sorted-set membership, batched: keys_sorted (B, V) ascending,
    query_keys (B, M). Returns int64 (B, M): the row of each hit, V for
    a miss (a gather index into a zero-padded table)."""
    V = keys_sorted.shape[-1]
    pos = torch.searchsorted(keys_sorted, query_keys)
    pos_c = pos.clamp(max=V - 1)
    hit = ((keys_sorted.gather(-1, pos_c) == query_keys)
           & (query_keys != KEY_SENTINEL))
    return torch.where(hit, pos_c, V)


def gather_rows(feats, idx):
    """feats (B, V, C), idx (B, M) int64 in [0, V] -> (B, M, C); index V
    reads a zero row."""
    B, V, C = feats.shape
    ext = torch.cat([feats, feats.new_zeros(B, 1, C)], dim=1)
    return ext.gather(1, idx[..., None].expand(-1, -1, C))


def _compact_unique(keys, capacity, feats=None):
    """Per row of keys (B, N): sort (stably, so the first point of a voxel
    is its representative, the MinkowskiEngine rule), keep the first row
    of each unique key, and compact the unique keys to the front in
    ascending order. Past `capacity` the largest keys are dropped.

    Returns (out_keys (B, capacity) int32, out_feats (B, capacity, C) or
    None)."""
    B, N = keys.shape
    sk, perm = torch.sort(keys, dim=1, stable=True)
    head = sk != KEY_SENTINEL
    head[:, 1:] &= sk[:, 1:] != sk[:, :-1]
    rank = torch.cumsum(head, dim=1) - 1
    # non-head rows and overflow all land in the spare slot `capacity`
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
             extent=DEFAULT_EXTENT, align_stride: int = 32) -> VoxelGrid:
    """points (B, N, 3) world metres; feats (B, N, C); point_valid (B, N)
    bool. Duplicate points in one voxel: the lowest original index wins.
    Returns a stride-1 VoxelGrid."""
    coords_raw = torch.floor(points / voxel_size).to(torch.int32)
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
    """Coordinate-only stride-2 downsample: child coords = floor(c / 2),
    de-duplicated. Features are zero (the strided conv fills them)."""
    gx, gy, gz = grid.extent
    child_extent = ((gx + 1) // 2, (gy + 1) // 2, (gz + 1) // 2)
    keys = torch.where(grid.valid, pack_keys(grid.coords // 2, child_extent),
                       KEY_SENTINEL)
    out_keys, _ = _compact_unique(keys, out_capacity)
    coords, valid = _coords_from_keys(out_keys, child_extent)
    B, C = grid.features.shape[0], grid.features.shape[-1]
    return VoxelGrid(
        coords=coords, keys=out_keys,
        features=grid.features.new_zeros(B, out_capacity, C),
        valid=valid, origin=grid.origin, stride=grid.stride * 2,
        extent=child_extent, voxel_size=grid.voxel_size)


def upsample_candidates(grid: VoxelGrid, out_capacity: int) -> VoxelGrid:
    """Generative stride-/2 upsample: every parent voxel proposes its 8
    children (MinkowskiGenerativeConvolutionTranspose coordinates)."""
    gx, gy, gz = grid.extent
    fine_extent = (gx * 2, gy * 2, gz * 2)
    offs = torch.tensor([[i, j, k] for i in (0, 1) for j in (0, 1)
                         for k in (0, 1)], dtype=torch.int32,
                        device=grid.coords.device)
    B, V, _ = grid.coords.shape
    cand = (grid.coords[:, :, None, :] * 2 + offs).reshape(B, V * 8, 3)
    v = grid.valid.repeat_interleave(8, dim=1)
    keys = torch.where(v, pack_keys(cand, fine_extent), KEY_SENTINEL)
    out_keys, _ = _compact_unique(keys, out_capacity)
    coords, valid = _coords_from_keys(out_keys, fine_extent)
    C = grid.features.shape[-1]
    return VoxelGrid(
        coords=coords, keys=out_keys,
        features=grid.features.new_zeros(B, out_capacity, C),
        valid=valid, origin=grid.origin, stride=grid.stride // 2,
        extent=fine_extent, voxel_size=grid.voxel_size)
