"""The trace reduction on a hand-made trace: busy time, waits, and each
launch's layer from its Python stack, or, on the autograd thread, from
its backward op's forward op."""

import pytest

from benchmark import trace as T

LAYERS = {"conv": ("vdetr_tpu_torch/ops/sparse_conv",),
          "rpe": ("vdetr_tpu_torch/ops/rpe_attention.py",)}


def ev(cat, name, ts, dur, tid=1, **args):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def make_events():
    return [
        ev("user_annotation", T.STEP_SPAN, 0, 100),
        ev("python_function", "vdetr_tpu_torch/models/backbone.py(9): f",
           1, 40),
        ev("python_function",
           "vdetr_tpu_torch/ops/sparse_conv_keyed.py(50): keyed_conv", 2, 20),
        ev("cpu_op", "_KeyedConv", 3, 15, **{"Sequence number": 7,
                                              "Fwd thread id": 0}),
        ev("cuda_runtime", "cudaLaunchKernel", 4, 2, correlation=1),
        ev("python_function",
           "vdetr_tpu_torch/ops/rpe_attention.py(80): attend", 25, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 26, 2, correlation=2),
        ev("cuda_runtime", "cudaStreamSynchronize", 60, 30),
        # the autograd thread: no Python frames, a backward op
        ev("cpu_op", "_KeyedConvBackward", 45, 10, tid=2,
           **{"Sequence number": 7, "Fwd thread id": 1}),
        ev("cuda_runtime", "cudaLaunchKernel", 46, 2, tid=2, correlation=3),
        ev("cuda_runtime", "cudaLaunchKernel", 56, 2, tid=2, correlation=4),
        ev("kernel", "conv_fwd", 10, 10, tid=7, correlation=1),
        ev("kernel", "rpe_fwd", 30, 5, tid=7, correlation=2),
        ev("kernel", "conv_bwd", 50, 20, tid=7, correlation=3),
        ev("kernel", "other", 70, 10, tid=7, correlation=4),
    ]


def test_busy_waits_and_layers():
    tr = T.Trace(make_events(), LAYERS)
    assert tr.window_us == 100
    assert tr.busy_us == pytest.approx(45)
    assert tr.wait_us == pytest.approx(30)
    assert tr.device_us("conv") == pytest.approx(30)
    assert tr.device_us("rpe") == pytest.approx(5)
    assert dict(tr.top_ops())["conv_bwd"] == 20


def test_idle_gaps_named_by_the_host():
    tr = T.Trace(make_events(), LAYERS)
    gaps = dict(tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(55)
    assert gaps["vdetr_tpu_torch/ops/sparse_conv_keyed.py(50): keyed_conv"] \
        == pytest.approx(10)
