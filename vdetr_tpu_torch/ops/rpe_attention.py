"""Vertex-RPE cross-attention: the wrapper of the Hopper kernel
`csrc/rpe_attention.cu` and its plain PyTorch version.

Replaces the TPU kernel `vdetr_tpu/ops/rpe_attention.py:
rpe_cross_attention_pallas` (forward, no dropout); the contract is
`rpe_cross_attention_reference`: logits `q . k` plus, for each of the 8
box corners, the trilinearly sampled table bias of the log-quantized
corner-to-key delta (optionally rotated into the object frame); masked
keys get -1e9; softmax over keys; average of the shared V head.

What bounds the kernel on the H100, and how its design answers it, is in
the source note of `csrc/rpe_attention.cu`.
"""

from __future__ import annotations

import torch

from vdetr_tpu_torch import kernels
from vdetr_tpu_torch.ops.rpe import log_quantize, trilinear_sample

NEG_INF = -1e9
_KERNEL_HEADS = 4
_KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)


def rpe_cross_attention_plain(q, k, v, corners, angles, key_xyz, tables,
                              key_valid=None, *, log_scale: float,
                              max_value: float, rotate: bool = False):
    """Plain version with the (B, H, nQ, nK) bias materialized."""
    attn = torch.einsum("bqhd,bkd->bhqk", q, k)
    kx = key_xyz[:, None, :, 0]
    ky = key_xyz[:, None, :, 1]
    kz = key_xyz[:, None, :, 2]
    if rotate:
        co = torch.cos(angles)[..., None]
        si = torch.sin(angles)[..., None]
    for c in range(8):
        corner = corners[:, :, c, :]
        dx = corner[:, :, 0:1] - kx
        dy = corner[:, :, 1:2] - ky
        dz = corner[:, :, 2:3] - kz
        if rotate:
            dx, dy = dx * co - dy * si, dx * si + dy * co
        bias = trilinear_sample(tables[c],
                                log_quantize(dx, log_scale, max_value),
                                log_quantize(dy, log_scale, max_value),
                                log_quantize(dz, log_scale, max_value))
        attn = attn + bias.transpose(0, 1)
    if key_valid is not None:
        attn = torch.where(key_valid[:, None, None, :], attn, NEG_INF)
    attn = torch.softmax(attn, dim=-1)
    return torch.einsum("bhqk,bkd->bqhd", attn, v)


def rpe_cross_attention(q, k, v, corners, angles, key_xyz, tables,
                        key_valid=None, *, log_scale: float,
                        max_value: float, rotate: bool = False):
    """q (B, nQ, H, hd) pre-scaled by hd^-0.5; k, v (B, nK, hd);
    corners (B, nQ, 8, 3); angles (B, nQ); key_xyz (B, nK, 3); tables
    (8, n, n, n, H); key_valid (B, nK) bool or None. Returns
    (B, nQ, H, hd) float32.

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors take
    `rpe_cross_attention_plain`."""
    if not q.is_cuda:
        return rpe_cross_attention_plain(
            q, k, v, corners, angles, key_xyz, tables, key_valid,
            log_scale=log_scale, max_value=max_value, rotate=rotate)
    B, nQ, H, hd = q.shape
    nK = k.shape[1]
    n = tables.shape[1]
    if H != _KERNEL_HEADS or hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the RPE kernel is built for {_KERNEL_HEADS} heads"
                         f" of width {_KERNEL_HEAD_DIMS}; got H={H}, hd={hd}")
    f32 = torch.float32
    kernels.check(q, f32, (B, nQ, H, hd), "q")
    kernels.check(k, f32, (B, nK, hd), "k")
    kernels.check(v, f32, (B, nK, hd), "v")
    kernels.check(corners, f32, (B, nQ, 8, 3), "corners")
    kernels.check(key_xyz, f32, (B, nK, 3), "key_xyz")
    kernels.check(tables, f32, (8, n, n, n, H), "tables")
    if key_valid is not None:
        kernels.check(key_valid, torch.bool, (B, nK), "key_valid")
    cossin = (torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)
              .contiguous() if rotate else None)
    if cossin is not None:
        kernels.check(cossin, f32, (B, nQ, 2), "angles")
    out = torch.empty_like(q)
    kernels.call(
        "rpe_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        corners.data_ptr(), None if cossin is None else cossin.data_ptr(),
        key_xyz.data_ptr(), tables.data_ptr(),
        None if key_valid is None else key_valid.data_ptr(), out.data_ptr(),
        B, nQ, nK, H, hd, n, float(log_scale), float(max_value), int(rotate),
        torch.cuda.current_stream(q.device).cuda_stream)
    rpe_cross_attention.launches += 1
    return out


rpe_cross_attention.launches = 0
