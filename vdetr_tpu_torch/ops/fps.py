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


# The form of kernel B on the main path, chosen by measurement
# (`python -m vdetr_tpu_torch.tools.fps_sweep`, PERF.md §6): CTAs per
# cluster, threads per CTA, and the exchange transport ("barrier": a
# cluster barrier; "push": st.async into the receivers' mbarriers). One
# rule for every N.
CLUSTER = 8
THREADS = 128
TRANSPORT = "push"
TRANSPORTS = ("barrier", "push")
# points a thread holds in registers, the kernel's template tiers; 512
# threads cap a thread's registers at 128, and so its points at 16
TIERS = (1, 2, 4, 8, 16, 32)
# shared-memory bytes of a CTA's float4 points on the memory path, past
# which they spill to device memory (`csrc/fps.cu` POINT_BYTES_MAX)
_POINT_BYTES_MAX = 200 * 1024


def fps_plan(N: int, cluster: int = CLUSTER, threads: int = THREADS):
    """(points per thread in registers, or 0 for the memory path; whether
    that path spills to device memory) for N points of a batch row: the
    smallest tier that holds N over `cluster` x `threads` threads."""
    per = -(-N // (cluster * threads))
    top = 16 if threads == 512 else 32
    for tier in TIERS:
        if tier <= top and per <= tier:
            return tier, False
    return 0, per * threads * 16 > _POINT_BYTES_MAX


def fps_launch(xyz, npoint: int, cluster: int = CLUSTER,
               threads: int = THREADS, transport: str = TRANSPORT,
               floor: bool = False):
    """Launch kernel B in one form on a CUDA (B, N, 3) float32 tensor and
    return the (B, npoint) int64 indices. `floor` times the exchange
    alone (its indices are no sample; it exists only at 32768 points).
    Raises if the form does not exist, cannot hold N, or its cluster does
    not fit the card. Counts nothing: `furthest_point_sample` is the
    main path's entry."""
    B, N, _ = xyz.shape
    kernels.check(xyz, torch.float32, (B, N, 3), "xyz")
    if N < 1:
        raise ValueError("furthest_point_sample needs at least one point")
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}")
    ppt, spills = fps_plan(N, cluster, threads)
    out = torch.empty(B, npoint, dtype=torch.int64, device=xyz.device)
    # the running distances' scratch, only where they leave the chip
    temp = (torch.empty(B, N, dtype=torch.float32, device=xyz.device)
            if spills else None)
    kernels.call("fps", xyz.data_ptr(),
                 0 if temp is None else temp.data_ptr(), out.data_ptr(), B,
                 N, npoint, cluster, threads, ppt,
                 int(transport == "push"), int(floor),
                 torch.cuda.current_stream(xyz.device).cuda_stream)
    return out


def furthest_point_sample(xyz, npoint: int):
    """xyz (B, N, 3) float32 -> (B, npoint) int64 indices.

    CUDA tensors launch the Hopper kernel in the main path's form (or
    raise); CPU tensors take `fps_plain`."""
    if not xyz.is_cuda:
        return fps_plain(xyz, npoint)
    out = fps_launch(xyz, npoint)
    furthest_point_sample.launches += 1
    return out


furthest_point_sample.launches = 0
