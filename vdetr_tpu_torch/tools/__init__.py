"""Probes of the port's Hopper kernels, run as `python -m
vdetr_tpu_torch.tools.<name>`, and the timing and bound helpers they share
with `chip_smoke.py`.

Nothing here runs at import time; `time_ms`, `device_ms` and `card`
need the card.
"""

from __future__ import annotations

import subprocess

import torch

# the card's peaks (NVIDIA's H100 SXM data sheet, at the 700 W limit):
# f32 outside the tensor cores, dense TF32 on them, and device-memory
# bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12


def bound_ms(nbytes: float, flops: float):
    """(least ms the card could take, what bounds it): bytes over the
    memory rate against flops over the f32 CUDA-core rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_split_tf32_ms(nbytes: float, flops: float):
    """(least ms, what bounds it) for f32 products done on the tensor
    cores in split TF32, three TF32 products each: bytes over the memory
    rate against 3 * flops over the dense TF32 rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call on the device (CUDA events around `reps` calls)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 10) -> float:
    """Device ms per call of `fn`: the summed durations of the device
    work it launches (`ab_kernels.profiled_calls`), for a kernel too short
    for CUDA events around its Python call to time anything but the
    host. If the profiler catches no device work at all, the CUDA-event
    time of the calls (`time_ms`, which then holds the host's overhead
    too: an upper bound)."""
    from vdetr_tpu_torch.tools.ab_kernels import profiled_calls

    calls = profiled_calls(fn, reps)
    us = sum(z - a for c in calls for _, a, z in c)
    return us / 1e3 / len(calls) if us > 0 else time_ms(fn, reps)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
