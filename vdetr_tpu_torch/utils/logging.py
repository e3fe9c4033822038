"""Metrics logging: console + JSONL + optional TensorBoard (a copy of
`vdetr_tpu/utils/logging.py`).

The reference logs to wandb (main.py:558-567) and ships an unused
tensorboardX wrapper (utils/logger.py). Zero-egress environments can't
reach wandb, so the default sink is a JSONL file per run (trivially
importable into wandb/TensorBoard later); a TensorBoard writer is used
when `tensorboardX` happens to be installed. Under data parallelism
rank 0 of the group alone writes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from vdetr_tpu_torch.parallel import dist


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, run_name: str = "run",
                 group=None):
        self.log_dir = log_dir
        self._fh = None
        self._tb = None
        if log_dir and dist.rank(group) == 0:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{run_name}.jsonl"), "a")
            try:
                from tensorboardX import SummaryWriter  # optional

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                self._tb = None

    def log(self, metrics: Dict, step: int, prefix: str = ""):
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            try:
                rec[key] = float(v)
            except (TypeError, ValueError):
                continue
            if self._tb is not None:
                self._tb.add_scalar(key, rec[key], step)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
        if self._tb is not None:
            self._tb.close()
