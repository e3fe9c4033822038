"""Furthest point sampling: the wrapper of the Hopper kernel `csrc/fps.cu`
and its plain PyTorch version.

Replaces the TPU kernel `vdetr_tpu/ops/fps.py:fps_pallas`; the contract
is `fps_jax` (reference pointnet2 sampling_gpu.cu:72-178):
- always starts at index 0;
- greedy: each step picks the point with the largest running min squared
  distance to the picked set, the first index on ties;
- points with squared norm <= 1e-3 are never picked and never update
  their running distance, so zero padding is excluded.

Squared norms and distances round as XLA evaluates `fps_jax`: with fused
multiply-adds, `fma(dz, dz, fma(dy, dy, dx * dx))`. On voxel lattice
points exact distance ties are common, and another rounding order picks
other indices; with this one the plain version, the kernel and `fps_jax`
pick equal indices.

What bounds the kernel on the H100, and how its design answers it, is in
the source note of `csrc/fps.cu`.
"""

from __future__ import annotations

import torch

from vdetr_tpu_torch import kernels

_SKIP_MAG = 1e-3
_INIT_DIST = 1e10


def _fma32(a, b, c):
    """float32 a * b + c with a single rounding (a fused multiply-add).
    The float64 product is exact; the float64 sum is rounded to odd (its
    exact error from TwoSum decides), which makes the final rounding to
    float32 correct."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _sq_norm(x, y, z):
    return _fma32(z, z, _fma32(y, y, x * x))


def fps_plain(xyz, npoint: int):
    """Plain version: one vectorised step per picked point, with the
    squared distances rounded as the kernel rounds them."""
    B, N, _ = xyz.shape
    x, y, z = (xyz[..., i].contiguous() for i in range(3))
    skip = _sq_norm(x, y, z) <= _SKIP_MAG
    temp = torch.full((B, N), _INIT_DIST, dtype=xyz.dtype, device=xyz.device)
    idxs = torch.zeros(B, npoint, dtype=torch.int64, device=xyz.device)
    old = torch.zeros(B, 1, dtype=torch.int64, device=xyz.device)
    neg = torch.tensor(-1.0, dtype=xyz.dtype, device=xyz.device)
    for j in range(1, npoint):
        dx = x - x.gather(1, old)
        dy = y - y.gather(1, old)
        dz = z - z.gather(1, old)
        d2 = torch.minimum(_sq_norm(dx, dy, dz), temp)
        temp = torch.where(skip, temp, d2)
        old = torch.where(skip, neg, d2).argmax(dim=1, keepdim=True)
        idxs[:, j] = old[:, 0]
    return idxs


def furthest_point_sample(xyz, npoint: int):
    """xyz (B, N, 3) float32 -> (B, npoint) int64 indices.

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors take
    `fps_plain`."""
    if not xyz.is_cuda:
        return fps_plain(xyz, npoint)
    B, N, _ = xyz.shape
    kernels.check(xyz, torch.float32, (B, N, 3), "xyz")
    if N < 1:
        raise ValueError("furthest_point_sample needs at least one point")
    out = torch.empty(B, npoint, dtype=torch.int64, device=xyz.device)
    # scratch for the running distances, used only past ~115k points,
    # where they no longer fit in the cluster's shared memory
    temp = torch.empty(B, N, dtype=torch.float32, device=xyz.device)
    kernels.call("fps", xyz.data_ptr(), temp.data_ptr(), out.data_ptr(), B, N,
                 npoint, torch.cuda.current_stream(xyz.device).cuda_stream)
    furthest_point_sample.launches += 1
    return out


furthest_point_sample.launches = 0
