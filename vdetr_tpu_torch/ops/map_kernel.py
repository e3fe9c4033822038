"""The exact 3^3 neighbour map of a voxel level: the wrapper of the Hopper
kernel `csrc/map_kernel.cu` and its plain PyTorch version.

Replaces the TPU kernel `vdetr_tpu/ops/map_kernel.py:window_map` (driven
by `stencil_map`) and is the counterpart of `sparse_conv.kernel_map` /
`_zrun_neighbors`, the map the JAX package builds off the TPU. Function,
per batch row b, query row v and offset k (x-major, z-fastest,
`kernel_offsets`): the local row of `pack(q[v] + off[k])` in b's sorted
input keys, `V_in` for a miss, an out-of-range neighbour or an invalid
query row. The result is (B, 27, V) int32, the JAX convention.

The TPU kernel's window anchors, `bad` rows and exact fix-up patch exist
because Mosaic cannot search a table per row; the Hopper kernel searches
directly, so its map is exact by construction. What bounds it on the H100
and how its design answers it is in the source notes of the kernel.
"""

from __future__ import annotations

import torch

from vdetr_tpu_torch import kernels
from vdetr_tpu_torch.ops.voxelize import KEY_SENTINEL, lookup, pack_keys


def kernel_offsets(kernel_size: int, device=None) -> torch.Tensor:
    """(k^3, 3) int32 offsets of an odd kernel, x-major / z-fastest."""
    r = kernel_size // 2
    rng = range(-r, r + 1)
    return torch.tensor([(i, j, k) for i in rng for j in rng for k in rng],
                        dtype=torch.int32, device=device)


def neighbour_map(in_keys, q_coords, q_valid, extent):
    """Plain version of `kernel_map`: one `searchsorted` lookup of all 27
    packed neighbour keys of every query row."""
    B, V, _ = q_coords.shape
    offs = kernel_offsets(3, q_coords.device)
    q = q_coords[:, None, :, :] + offs[None, :, None, :]      # (B, 27, V, 3)
    qk = torch.where(q_valid[:, None, :], pack_keys(q, extent), KEY_SENTINEL)
    nbr = lookup(in_keys, qk.reshape(B, 27 * V)).reshape(B, 27, V)
    return nbr.to(torch.int32)


def kernel_map(in_keys, q_coords, q_valid, extent):
    """(B, 27, V) int32 neighbour rows of the 3^3 stencil centred at each
    query, in the input table; V_in for a miss or an invalid query row.

    in_keys (B, V_in) int32 ascending (empty slots KEY_SENTINEL);
    q_coords (B, V, 3) int32 in the input lattice (a level's own coords,
    or 2 * out_coords for a stride-2 conv); q_valid (B, V) bool; extent
    the input lattice's (GX, GY, GZ).

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors take
    `neighbour_map`."""
    if not in_keys.is_cuda:
        return neighbour_map(in_keys, q_coords, q_valid, extent)
    B, V_in = in_keys.shape
    V = q_coords.shape[1]
    gx, gy, gz = (int(e) for e in extent)
    kernels.check(in_keys, torch.int32, (B, V_in), "in_keys")
    kernels.check(q_coords, torch.int32, (B, V, 3), "q_coords")
    kernels.check(q_valid, torch.bool, (B, V), "q_valid")
    if gx * gy * gz > 2 ** 31:  # the largest key must fit in int32
        raise ValueError(f"extent {extent} does not pack into int32 keys")
    nbr = torch.empty(B, 27, V, dtype=torch.int32, device=in_keys.device)
    kernels.call("map_kernel", in_keys.data_ptr(), q_coords.data_ptr(),
                 q_valid.data_ptr(), nbr.data_ptr(), B, V_in, V, gx, gy, gz,
                 torch.cuda.current_stream(in_keys.device).cuda_stream)
    kernel_map.launches += 1
    return nbr


kernel_map.launches = 0
