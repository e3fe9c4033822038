"""Keyed 3x3x3 sparse convolution: the wrapper of the Hopper kernel
`csrc/keyed_conv.cu` and its plain PyTorch version.

Replaces the TPU kernel `vdetr_tpu/ops/sparse_conv_keyed.py:keyed_conv`.
The function, per query row v and kernel offset k (x-major, z-fastest,
`kernel_offsets`): pack `q[v] + off[k]` with `pack_keys`' bounds check,
find it in the sorted keys of the input table, and accumulate
`feats[hit] @ W[k]` in float32; a miss contributes 0. Its contract in the
JAX package is `sparse_conv._gather_matmul` over `_zrun_neighbors`.

What bounds the kernel on the H100, and how its design answers it, is in
the source note of `csrc/keyed_conv.cu`.
"""

from __future__ import annotations

import torch

from vdetr_tpu_torch import kernels
from vdetr_tpu_torch.ops.voxelize import (KEY_SENTINEL, gather_rows, lookup,
                                          pack_keys)


def kernel_offsets(kernel_size: int, device=None) -> torch.Tensor:
    """(k^3, 3) int32 offsets of an odd kernel, x-major / z-fastest."""
    r = kernel_size // 2
    rng = range(-r, r + 1)
    return torch.tensor([(i, j, k) for i in rng for j in rng for k in rng],
                        dtype=torch.int32, device=device)


def keyed_conv_plain(feats, in_keys, q_coords, q_valid, extent, weights):
    """Plain version: one `searchsorted` lookup per offset, then a row
    gather and a matmul per offset, accumulated in float32."""
    B, V, _ = q_coords.shape
    K = weights.shape[0]
    offs = kernel_offsets(3, q_coords.device)
    q = q_coords[:, None, :, :] + offs[None, :, None, :]      # (B, 27, V, 3)
    qk = torch.where(q_valid[:, None, :], pack_keys(q, extent), KEY_SENTINEL)
    nbr = lookup(in_keys, qk.reshape(B, K * V)).reshape(B, K, V)
    out = feats.new_zeros(B, V, weights.shape[-1], dtype=torch.float32)
    for k in range(K):
        out = out + torch.matmul(gather_rows(feats, nbr[:, k]), weights[k])
    return out


def keyed_conv(feats, in_keys, q_coords, q_valid, extent, weights):
    """Sparse 3^3 conv of `feats` at query sites.

    feats (B, V_in, C) float32; in_keys (B, V_in) int32 ascending (empty
    slots KEY_SENTINEL); q_coords (B, V, 3) int32 in the input lattice;
    q_valid (B, V) bool; extent the input lattice's (GX, GY, GZ);
    weights (27, C, Co) float32. Returns (B, V, Co) float32, zero at
    invalid query rows.

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors take
    `keyed_conv_plain`."""
    if not feats.is_cuda:
        return keyed_conv_plain(feats, in_keys, q_coords, q_valid, extent,
                                weights)
    B, V_in, C = feats.shape
    V = q_coords.shape[1]
    Co = weights.shape[-1]
    gx, gy, gz = (int(e) for e in extent)
    kernels.check(feats, torch.float32, (B, V_in, C), "feats")
    kernels.check(in_keys, torch.int32, (B, V_in), "in_keys")
    kernels.check(q_coords, torch.int32, (B, V, 3), "q_coords")
    kernels.check(q_valid, torch.bool, (B, V), "q_valid")
    kernels.check(weights, torch.float32, (27, C, Co), "weights")
    if gx * gy * gz > 2 ** 31:  # the largest key must fit in int32
        raise ValueError(f"extent {extent} does not pack into int32 keys")
    out = torch.empty(B, V, Co, dtype=torch.float32, device=feats.device)
    # wide inputs are the deep levels, where few row tiles are live: three
    # blocks share each tile's 27 offsets (partial sums added in order)
    splits = 3 if C >= 256 else 1
    scratch = (torch.empty(splits, B, V, Co, dtype=torch.float32,
                           device=feats.device) if splits > 1 else out)
    kernels.call("keyed_conv", feats.data_ptr(), in_keys.data_ptr(),
                 q_coords.data_ptr(), q_valid.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), B, V_in, V, C, Co, gx,
                 gy, gz, splits,
                 torch.cuda.current_stream(feats.device).cuda_stream)
    keyed_conv.launches += 1
    return out


keyed_conv.launches = 0

