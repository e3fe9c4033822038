"""Exact linear assignment on the host: a numpy port of
`vdetr_tpu/ops/hungarian.py:_solve_single` (Jonker-Volgenant shortest
augmenting paths, the algorithm scipy implements).

The arithmetic is the JAX solver's, in float32 and in the same order, and
ties go to the first index as `jnp.argmin` sends them, so on the same
costs the assignments are the JAX package's. The criterion gathers every
cost matrix of a step into one device-to-host copy before it calls this.
"""

from __future__ import annotations

import numpy as np

_INF = np.float32(np.inf)


def _solve_single(cost: np.ndarray, n_valid: int) -> np.ndarray:
    """cost (n, m) float32 with n <= m; assigns rows 0..n_valid-1 to
    distinct columns at least total cost. Returns col4row (n,) int32,
    -1 for the rows past n_valid."""
    n, m = cost.shape
    u = np.zeros(n, np.float32)
    v = np.zeros(m, np.float32)
    row4col = np.full(m, -1, np.int32)
    col4row = np.full(n, -1, np.int32)
    for cur_row in range(min(int(n_valid), n)):
        shortest = np.full(m, _INF, np.float32)
        path = np.full(m, -1, np.int32)
        scanned_c = np.zeros(m, bool)
        scanned_r = np.zeros(n, bool)
        i, sink, minval = cur_row, -1, np.float32(0.0)
        while sink < 0:  # Dijkstra over reduced costs
            scanned_r[i] = True
            red = minval + cost[i] - u[i] - v
            better = ~scanned_c & (red < shortest)
            shortest[better] = red[better]
            path[better] = i
            j = int(np.argmin(np.where(scanned_c, _INF, shortest)))
            minval = shortest[j]
            scanned_c[j] = True
            if row4col[j] < 0:
                sink = j
            else:
                i = int(row4col[j])
        # potentials
        u[cur_row] += minval
        other = scanned_r.copy()
        other[cur_row] = False
        assigned = col4row[other]
        u[other] = u[other] + minval - shortest[assigned]
        v[scanned_c] = v[scanned_c] - (minval - shortest[scanned_c])
        # augment along the path from the sink back to cur_row
        j = sink
        while True:
            i = int(path[j])
            row4col[j] = i
            j, col4row[i] = int(col4row[i]), j
            if i == cur_row:
                break
    return col4row


def hungarian(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """Batched exact assignment: cost (B, n, m) with n <= m, n_valid (B,)
    rows to assign. Returns col4row (B, n) int32, -1 for skipped rows."""
    cost = np.asarray(cost, np.float32)
    assert cost.shape[1] <= cost.shape[2], "need rows <= cols; transpose"
    return np.stack([_solve_single(c, k) for c, k in zip(cost, n_valid)])
