"""Small utilities (torch counterpart of `vdetr_tpu/utils/misc.py`;
reference utils/misc.py)."""

from __future__ import annotations

from collections import deque


class SmoothedValue:
    """A windowed average meter (reference utils/misc.py:40-100): `avg`,
    `max` and `value` over the last `window_size` updates, `global_avg`
    over all of them, each weighted by its `n`."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0
