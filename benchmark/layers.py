"""The readings behind the per-layer metrics (`metrics/<name>.py`), from
a traced run's context: `kind` ("train" or "eval"), the `trace` of the
profiled steps (`benchmark/trace.py`), the `work` of each batch of the
feed (`benchmark/flops.py`), the measured window's length and the batch
of each step in it (`window_s`, `window_pos`), the batches of the
profiled steps (`traced_pos`), the trace of as many steps more with the
Python tracer on (`stack_trace`, `stack_pos`: the launches' layers; the
tracer slows the host, so only device times are read from it), and the
configuration's `dtype`.

Each returns (value, unit), or None where it has nothing to read: a
share of a roofline or of a peak is never reported as 0."""

from __future__ import annotations

from benchmark.flops import PEAK_FLOPS

# the port's source files of each layer, as the launching stack names them
LAYERS = {
    "sparse_conv": ("vdetr_tpu_torch/ops/sparse_conv",),
    "rpe_attn": ("vdetr_tpu_torch/ops/rpe_attention.py",),
}


def mfu(ctx, kind):
    """The whole step's useful flops over the measured window, as a share
    of the chip's peak in the configuration's precision."""
    if ctx.kind != kind or not ctx.window_pos:
        return None
    flops = sum(ctx.work[p].total_flops for p in ctx.window_pos)
    return 100.0 * flops / (ctx.window_s * PEAK_FLOPS[ctx.dtype]), "%"


def device_idle(ctx, kind):
    """The share of the profiled steps' host time the device ran nothing."""
    if ctx.kind != kind or ctx.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.window_us), "%"


def host_busy(ctx, kind):
    """Host ms a profiled step, less the time spent waiting on the device
    in synchronizing calls."""
    if ctx.kind != kind:
        return None
    tr = ctx.trace
    return (tr.window_us - tr.wait_us) / 1e3 / len(tr.steps), "ms"


def roofline(ctx, kind, layer):
    """The layer's bound (`flops.py`) over the device time of the launches
    its modules made, in the profiled steps."""
    if ctx.kind != kind:
        return None
    device_s = ctx.stack_trace.device_us(layer) / 1e6
    if device_s <= 0:
        return None
    bound_s = sum(ctx.work[p].bound.get(layer, 0.0) for p in ctx.stack_pos)
    if bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s, "%"
