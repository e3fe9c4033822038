"""Probes of the port's Hopper kernels, run as `python -m
vdetr_tpu_torch.tools.<name>`, and the timing, bound, launch-count and
process helpers they share with `chip_smoke.py` and the tests.

Nothing here runs at import time; `time_ms`, `device_ms`, `graph_ms`
and `card` need the card.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time

import torch

# the card's peaks (NVIDIA's H100 SXM data sheet, at the 700 W limit):
# f32 outside the tensor cores, dense TF32 on them, and device-memory
# bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_ms(nbytes: float, flops: float):
    """(least ms the card could take, what bounds it): bytes over the
    memory rate against flops over the f32 CUDA-core rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_bf16_ms(nbytes: float, flops: float, products: int = 1):
    """(least ms, what bounds it) for products on the tensor cores in
    bf16, `products` bf16 MMAs each (2 where an f32 operand is split into
    two bf16 halves): bytes over the memory rate against products * flops
    over the dense bf16 rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = products * flops / PEAK_BF16_FLOPS * 1e3
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


def graph_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device ms per call of `fn` for a kernel whose wrapper's Python
    takes longer than its launch: `launches` calls captured into one CUDA
    graph, replayed `reps` times between CUDA events, so that the launches
    run back to back without the host between them (the gaps between
    them are counted). `fn` allocates its outputs in the graph's pool."""
    fn()  # builds and loads what the call needs outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * launches)


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


def launch_counters():
    """{kernel name: its wrapper}: each wrapper counts its launches on
    its `launches` attribute (CUDA tensors only; the plain versions count
    nothing)."""
    from vdetr_tpu_torch.geometry.nms import nms_3d_samecls_mask
    from vdetr_tpu_torch.ops.fps import furthest_point_sample
    from vdetr_tpu_torch.ops.hungarian import auction
    from vdetr_tpu_torch.ops.map_kernel import kernel_map
    from vdetr_tpu_torch.ops.rotated_iou import rotated_intersection_areas
    from vdetr_tpu_torch.ops.rpe_attention import (rpe_cross_attention,
                                                   rpe_cross_attention_bwd,
                                                   rpe_table_sum)
    from vdetr_tpu_torch.ops.sparse_conv_keyed import (keyed_conv,
                                                       keyed_conv_bf16,
                                                       keyed_conv_dw,
                                                       keyed_conv_dw_bf16)
    from vdetr_tpu_torch.ops.sparse_conv_kernel import (mapped_conv,
                                                        mapped_conv_bf16,
                                                        mapped_conv_dw,
                                                        mapped_conv_dw_bf16)
    from vdetr_tpu_torch.tools.dot_micro import dot_micro
    from vdetr_tpu_torch.tools.rpe_ablate import rpe_ablate

    return {"keyed_conv": keyed_conv, "fps": furthest_point_sample,
            "rpe_cross_attention": rpe_cross_attention,
            "keyed_conv_dw": keyed_conv_dw,
            "rpe_cross_attention_bwd": rpe_cross_attention_bwd,
            "rpe_table_sum": rpe_table_sum, "kernel_map": kernel_map,
            "mapped_conv": mapped_conv, "mapped_conv_dw": mapped_conv_dw,
            "rpe_ablate": rpe_ablate, "dot_micro": dot_micro,
            "nms": nms_3d_samecls_mask, "auction": auction,
            "rotated_iou": rotated_intersection_areas,
            "keyed_conv_bf16": keyed_conv_bf16,
            "keyed_conv_dw_bf16": keyed_conv_dw_bf16,
            "mapped_conv_bf16": mapped_conv_bf16,
            "mapped_conv_dw_bf16": mapped_conv_dw_bf16}


def _rank_main(rank: int, fn, spec: dict, out: str) -> None:
    torch.save(fn(rank, spec), os.path.join(out, f"rank{rank}.pt"))


def run_ranks(fn, world: int, spec: dict, timeout: float) -> list:
    """`fn(rank, spec)` in `world` spawned processes, ranks 0 to world - 1,
    under a time limit of `timeout` s; returns each rank's return value
    (saved with torch.save), in rank order. `fn` must be importable by
    module (the processes are spawned). Raises when a rank raises or dies
    (the others are stopped) or when the time runs out (every rank is
    killed): a rank that fails never leaves the others waiting here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out:
        ctx = mp.start_processes(_rank_main, args=(fn, spec, out),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{fn.__name__} on {world} ranks: "
                                       f"not done after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(out, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
