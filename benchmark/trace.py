"""Reduction of a `torch.profiler` trace (CPU and CUDA activity) of the
profiled steps to what the per-layer readers take. A traced run takes
two: one without the Python tracer (busy, idle and host times, the
breakdown) and one with it (the launches' layers; the tracer slows the
host, so only device times are read from that one).

- Device busy time: the union of the device's kernel, copy and memset
  intervals inside the steps (user annotations left out), as the frozen
  copy of `chip_smoke.py:profile_step` takes it.
- A launch's layer: the port module on its launching Python stack. A
  launch (a CUDA runtime call) on a thread the Python tracer saw takes the
  frames that enclose it; one that the autograd engine issued takes its
  backward op's forward op (the op with the same sequence number), and
  that op's frames. A layer is a list of the port's source files: a frame
  `vdetr_tpu_torch/ops/sparse_conv_keyed.py(...)` belongs to the layer
  that names `ops/sparse_conv_keyed.py`. Kernel names play no part.
- Host busy time: the steps' host time less the time a thread waited on
  the device inside a synchronizing runtime call.
- Idle gaps: the stretches inside the steps where the device ran
  nothing, summed by what the main thread was in at each gap's midpoint:
  the innermost port or harness frame where the trace has frames, else
  the innermost op or runtime call, else "host" (Python between ops).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")
STEP_SPAN = "benchmark.step"
PACKAGES = ("vdetr_tpu_torch/", "benchmark/")


def _union(spans: Sequence[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _clip(spans, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


class Trace:
    """The profiled steps of one traced run (times in microseconds)."""

    def __init__(self, events: List[dict], layers: Dict[str, Sequence[str]]):
        self.layers = layers
        steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("name") == STEP_SPAN and "dur" in e
                       and e.get("cat") == "user_annotation")
        self.steps = steps
        lo, hi = steps[0][0], steps[-1][1]
        self.window_us = hi - lo
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and "dur" in e and e["ts"] < hi
                       and e["ts"] + e["dur"] > lo]
        self.busy_us = _union(_clip([(e["ts"], e["ts"] + e["dur"])
                                     for e in self.device], lo, hi))
        by_tid = defaultdict(list)
        for e in events:
            if e.get("cat") in ("python_function", "cpu_op", "cuda_runtime",
                                "cuda_driver") and "dur" in e:
                by_tid[e["tid"]].append(e)
        self.main_tid = next(e["tid"] for e in events
                             if e.get("name") == STEP_SPAN
                             and e.get("cat") == "user_annotation")
        self._by_tid = by_tid
        self._layer_of_corr = self._attribute()
        waits = [(e["ts"], e["ts"] + e["dur"]) for evs in by_tid.values()
                 for e in evs if e.get("cat") in ("cuda_runtime",
                                                  "cuda_driver")
                 and e["name"] in SYNC_CALLS]
        self.wait_us = _union(_clip(waits, lo, hi))

    # ---- attribution ----
    def layer_of_frame(self, name: str) -> Optional[str]:
        """The layer whose files name the frame `name`, or None."""
        return next((layer for layer, files in self.layers.items()
                     if any(f in name for f in files)), None)

    def _attribute(self) -> Dict[int, Optional[str]]:
        """{correlation id: layer} of every launch. One sweep per thread
        with a stack of the open events, each entry carrying the layer of
        its innermost Python frame that names one, whether any Python
        frame is open, and the sequence numbers of the open ops."""
        fwd_layer: Dict[int, Optional[str]] = {}
        pending = []  # (correlation, enclosing ops' sequence numbers)
        out: Dict[int, Optional[str]] = {}
        for evs in self._by_tid.values():
            evs.sort(key=lambda e: (e["ts"], -e["dur"]))
            # (end, layer, any python frame, sequence numbers)
            stack: List[tuple] = [(float("inf"), None, False, ())]
            for e in evs:
                t = e["ts"]
                while stack[-1][0] <= t:
                    stack.pop()
                _, layer, py, seqs = stack[-1]
                cat = e.get("cat")
                args = e.get("args") or {}
                if cat == "python_function":
                    layer = self.layer_of_frame(e["name"]) or layer
                    py = True
                elif cat == "cpu_op":
                    seq = args.get("Sequence number")
                    if seq is not None:
                        if not args.get("Fwd thread id"):
                            fwd_layer.setdefault(seq, layer)
                        seqs = seqs + (seq,)
                else:
                    corr = args.get("correlation")
                    if corr is not None:
                        if py:
                            out[corr] = layer
                        else:
                            pending.append((corr, seqs))
                stack.append((t + e["dur"], layer, py, seqs))
        for corr, seqs in pending:
            out[corr] = next((fwd_layer[s] for s in reversed(seqs)
                              if fwd_layer.get(s)), None)
        return out

    def layer_of(self, event: dict) -> Optional[str]:
        return self._layer_of_corr.get((event.get("args") or {})
                                       .get("correlation"))

    def device_us(self, layer: str) -> float:
        return sum(e["dur"] for e in self.device if self.layer_of(e) == layer)

    # ---- breakdown ----
    def top_ops(self, n: int = 10):
        by = defaultdict(float)
        for e in self.device:
            by[e["name"][:120]] += e["dur"]
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """Idle device time inside the steps, summed by what the main
        thread was doing at each gap's midpoint."""
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        main = sorted(self._by_tid[self.main_tid],
                      key=lambda e: (e["ts"], -e["dur"]))
        starts = [e["ts"] for e in main]
        by = defaultdict(float)
        for lo, hi in self.steps:
            t, end = lo, lo
            for a, b in _clip(spans, lo, hi) + [(hi, hi)]:
                if a > end:
                    by[self._doing(main, starts, (end + a) / 2)] += a - end
                end = max(end, b)
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def _doing(self, main, starts, t) -> str:
        i = bisect.bisect_right(starts, t)
        best, best_py = None, None
        for e in main[max(0, i - 5000):i]:
            if e["ts"] <= t < e["ts"] + e["dur"]:
                if e.get("cat") == "python_function" and any(
                        p in e["name"] for p in PACKAGES):
                    best_py = e["name"]
                elif e.get("cat") in ("cpu_op", "cuda_runtime"):
                    best = e["name"]
        return (best_py or best or "host")[:120]


def load(path: str, layers: Dict[str, Sequence[str]]) -> Trace:
    with open(path) as f:
        return Trace(json.load(f)["traceEvents"], layers)
