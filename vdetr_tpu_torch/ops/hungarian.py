"""The matcher's assignment solvers.

`hungarian`: exact linear assignment on the host, a numpy port of
`vdetr_tpu/ops/hungarian.py:_solve_single` (Jonker-Volgenant shortest
augmenting paths, the algorithm scipy implements). The arithmetic is the
JAX solver's, in float32 and in the same order, and ties go to the first
index as `jnp.argmin` sends them, so on the same costs the assignments
are the JAX package's. The criterion gathers every cost matrix of a step
into one device-to-host copy before it calls this (`matcher_impl="jv"`).

`auction` and `auction_capacity`: the eps-optimal forward auction
(Bertsekas) of `vdetr_tpu/ops/hungarian.py:_auction_single` and its
capacity form for the repeat-tiled GT rows, `_auction_capacity_single`
(`matcher_impl="auction"`, the default). CPU tensors take the plain
versions here, which follow the JAX `lax.while_loop`s literally in
float32: the same eps from the spread of the genuine costs, the same
bids in the same order of operations, top-k in `lax.top_k`'s order (a
stable descending sort: the lower column first among equal values), the
same -1e30 sentinel, ties to the lowest row or class. CUDA tensors launch
kernel M (`csrc/auction.cu`), which runs every bidding round of every
problem of the batch on the card in one launch, with no host sync, and
gives the plain versions' assignments bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from vdetr_tpu_torch import kernels

_INF = np.float32(np.inf)
# the most slots (repeat + 1) a class takes its top values of a round:
# kernel M keeps them one a lane of a warp
AUCTION_MAX_SLOTS = 32
# kernel M keeps a problem's prices, owners and bids, 16 bytes a column,
# and 4 bytes a row in one block's shared memory
AUCTION_MAX_SHARED = 227 * 1024


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


# --------------------------------------------------------------------------
# The auction: plain versions
# --------------------------------------------------------------------------

def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _order_key(x):
    """int32 keys of float32 x in the order lax.top_k sorts by: -0 below
    +0, equal keys for equal bits."""
    bits = x.view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _eps(values, genuine, eps_frac: float):
    """(P,) eps_frac * spread of the genuine values (valid rows, cost <
    1e5) of each problem, the spread at least 1e-3 and 1 where no entry is
    genuine: the sentinels must not inflate it."""
    inf = _f32(np.inf, values)
    vmax = torch.where(genuine, values, -inf).amax(dim=(1, 2))
    vmin = torch.where(genuine, values, inf).amin(dim=(1, 2))
    spread = vmax - vmin
    spread = torch.where(torch.isfinite(spread), spread, _f32(1.0, values))
    spread = torch.maximum(spread, _f32(1e-3, values))
    return _f32(eps_frac, values) * spread


def auction_plain(cost, n_valid, eps_frac: float = 0.002,
                  max_iters: int = 3000):
    """The plain version of `auction` (`_auction_single` under vmap): all
    unassigned rows bid at once on their best column, the best bid takes
    each column (the lowest row among equal bids) and evicts its holder.
    A batch's problems run in lockstep, each frozen once it is done, as
    the vmapped `while_loop` runs them. Returns (col4row (P, n) int32,
    rounds (P,) int64)."""
    cost = cost.float()
    P, n, m = cost.shape
    dev = cost.device
    values = -cost
    row_ids = torch.arange(n, device=dev)
    row_valid = row_ids[None, :] < n_valid.to(dev)[:, None]
    eps = _eps(values, row_valid[:, :, None] & (cost < 1e5), eps_frac)[:,
                                                                      None]
    neg_inf = _f32(-np.inf, cost)
    col4row = torch.full((P, n), -1, dtype=torch.int64, device=dev)
    prices = torch.zeros(P, m, dtype=torch.float32, device=dev)
    rounds = torch.zeros(P, dtype=torch.int64, device=dev)
    while True:
        unassigned = row_valid & (col4row < 0)
        active = unassigned.any(dim=1) & (rounds < max_iters)
        if not bool(active.any()):
            break
        net = values - prices[:, None, :]
        j1 = net.argmax(dim=2)  # the first column among equal values
        v1 = net.gather(2, j1[:, :, None])[:, :, 0]
        v2 = net.scatter(2, j1[:, :, None], -np.inf).amax(dim=2)
        v2 = torch.where(torch.isfinite(v2), v2, v1 - eps)
        bid = prices.gather(1, j1) + (v1 - v2) + eps
        bid = torch.where(unassigned, bid, neg_inf)
        col_best = torch.full((P, m), -np.inf, device=dev).scatter_reduce(
            1, j1, bid, "amax")
        maybe_won = unassigned & (bid >= col_best.gather(1, j1))
        # the lowest row among equal best bids
        winner = torch.full((P, m), n, device=dev).scatter_reduce(
            1, j1, torch.where(maybe_won, row_ids, n), "amin")
        won = maybe_won & (winner.gather(1, j1) == row_ids)
        has_winner = winner < n
        held = col4row.clamp(0, m - 1)
        evicted = ((col4row >= 0) & has_winner.gather(1, held)
                   & (winner.gather(1, held) != row_ids))
        new = torch.where(evicted, -1, col4row)
        new = torch.where(won, j1, new)
        col4row = torch.where(active[:, None], new, col4row)
        prices = torch.where(active[:, None] & has_winner, col_best, prices)
        rounds = rounds + active.long()
    return torch.where(row_valid, col4row, -1).to(torch.int32), rounds


def auction_capacity_plain(cost, n_valid, repeat: int,
                           eps_frac: float = 0.002, max_iters: int = 3000):
    """The plain version of `auction_capacity` (`_auction_capacity_single`
    under vmap). Row r < n_valid of the repeat-tiled matrix is a copy of
    GT class r % g (g = n_valid // repeat); class c's values are row c.
    Each round every class short of `repeat` columns bids on its top
    `need` columns with the (need+1)-th best as the cutoff; the best bid
    takes each column (the lowest class among equal bids). Then each
    class's columns go to its copies c, c + g, ... in ascending column
    order. Returns (col4row (P, n) int32, rounds (P,) int64)."""
    cost = cost.float()
    P, n, m = cost.shape
    dev = cost.device
    g_max = n // repeat
    n_valid = n_valid.to(dev)
    g = n_valid // repeat
    class_ids = torch.arange(g_max, device=dev)
    class_valid = class_ids[None, :] < g[:, None]
    values = -cost[:, :g_max]
    cap = torch.where(class_valid, repeat, 0)
    eps = _eps(values, class_valid[:, :, None] & (cost[:, :g_max] < 1e5),
               eps_frac)[:, None, None]
    neg = _f32(-1e30, cost)  # -inf breeds nans in topv - vcut
    half = neg / 2
    neg_inf = _f32(-np.inf, cost)
    slot = torch.arange(repeat + 1, device=dev)
    col4class = torch.full((P, m), -1, dtype=torch.int64, device=dev)
    prices = torch.zeros(P, m, dtype=torch.float32, device=dev)
    rounds = torch.zeros(P, dtype=torch.int64, device=dev)
    while True:
        own = col4class[:, None, :] == class_ids[None, :, None]
        need = cap - own.sum(dim=2)
        active = (need > 0).any(dim=1) & (rounds < max_iters)
        if not bool(active.any()):
            break
        net = values - prices[:, None, :]
        net = torch.where(own | ~class_valid[:, :, None], neg, net)
        # lax.top_k's order: the larger value first (+0 above -0), the
        # lower column first among equal values
        topj = torch.sort(_order_key(net), dim=2, descending=True,
                          stable=True).indices[:, :, :repeat + 1]
        topv = net.gather(2, topj)
        vcut = topv.gather(2, need.clamp(0, repeat)[:, :, None])
        bidding = ((slot < need[:, :, None]) & (topv > half)
                   & (vcut > half))
        flat_j = topj.reshape(P, -1)
        bid = (prices.gather(1, flat_j).reshape(topj.shape) + (topv - vcut)
               + eps)
        flat_b = torch.where(bidding, bid, neg_inf).reshape(P, -1)
        flat_c = class_ids[None, :, None].expand(topj.shape).reshape(P, -1)
        col_best = torch.full((P, m), -np.inf, device=dev).scatter_reduce(
            1, flat_j, flat_b, "amax")
        cand = torch.where(torch.isfinite(flat_b)
                           & (flat_b >= col_best.gather(1, flat_j)),
                           flat_c, g_max)
        winner = torch.full((P, m), g_max, device=dev).scatter_reduce(
            1, flat_j, cand, "amin")
        upd = active[:, None] & (winner < g_max) & torch.isfinite(col_best)
        col4class = torch.where(upd, winner, col4class)
        prices = torch.where(upd, col_best, prices)
        rounds = rounds + active.long()
    # copy d of class c is row c + d * g; the class's columns go to its
    # copies in ascending column order
    onehot = col4class[:, None, :] == class_ids[None, :, None]
    rank = torch.cumsum(onehot.long(), dim=2) - 1
    rk = rank.gather(1, col4class.clamp(0, max(g_max - 1, 0))[:, None, :]
                     )[:, 0]
    row = torch.where(col4class >= 0, col4class + g[:, None] * rk, n)
    col4row = torch.full((P, n + 1), -1, dtype=torch.int64, device=dev)
    col4row.scatter_(1, row, torch.arange(m, device=dev).expand(P, m))
    col4row = col4row[:, :n]
    row_valid = torch.arange(n, device=dev)[None, :] < n_valid[:, None]
    return torch.where(row_valid, col4row, -1).to(torch.int32), rounds


# --------------------------------------------------------------------------
# The auction: kernel M
# --------------------------------------------------------------------------

def lane_merge_top(values, take: int, lanes: int = 32) -> list:
    """Kernel M's selection of a class's top `take` entries under the
    capacity auction, in Python: the model its source
    (`csrc/auction.cu:row_top`) follows, for a test against `lax.top_k`.
    values (m,) float32 net values -> [(value, column), ...] in order.
    Each entry is a key, the order-preserving bits of its value above
    0xffffffff - column (top_k's order: +0 above -0, the lower column
    among equal values); each lane keeps the top two keys of its columns
    (j = lane, lane + lanes, ...); a pop takes the largest head, the
    lane's second key moves up, and a lane emptied while pops remain
    takes its top two keys below the last it gave."""
    v = np.asarray(values, np.float32).view(np.uint32)
    bits = np.where(v & 0x80000000, ~v, v | 0x80000000).astype(np.uint64)
    keys = [int(b) << 32 | (0xFFFFFFFF - j) for j, b in enumerate(bits)]

    def top2(lane, below):
        got = sorted((k for k in keys[lane::lanes] if k < below),
                     reverse=True)[:2]
        return got + [0] * (2 - len(got))

    heads = [top2(lane, 1 << 64) for lane in range(lanes)]
    out = []
    for s in range(take):
        w = max(h[0] for h in heads)
        out.append(w)
        if w:
            lane = next(i for i, h in enumerate(heads) if h[0] == w)
            heads[lane] = [heads[lane][1], 0]
            if heads[lane][0] == 0 and s + 1 < take:
                heads[lane] = top2(lane, w)

    def value(k):
        o = np.uint32(k >> 32)
        o = o & 0x7FFFFFFF if o & 0x80000000 else ~o
        return float(np.uint32(o).view(np.float32))

    return [(value(k), 0xFFFFFFFF - (k & 0xFFFFFFFF)) if k
            else (-np.inf, 0x7FFFFFFF) for k in out]


def auction_shared_bytes(n: int, m: int) -> int:
    """Kernel M's dynamic shared memory for a problem of n rows and m
    columns (csrc/auction.cu: best bids, prices, owners; row state)."""
    return 16 * m + 4 * n + 256


def auction_launch(cost, n_valid, repeat: int = 1, eps_frac: float = 0.002,
                   max_iters: int = 3000):
    """Launch kernel M on CUDA tensors: cost (P, n, m) float32, n_valid
    (P,) integer. repeat 1 solves each problem by the plain auction,
    repeat > 1 by the capacity auction over n // repeat classes. Returns
    (col4row (P, n) int32, rounds (P,) int32). Counts nothing: `auction`
    and `auction_capacity` are the main path's entries."""
    P, n, m = cost.shape
    kernels.check(cost, torch.float32, (P, n, m), "cost")
    if repeat < 1 or repeat + 1 > AUCTION_MAX_SLOTS:
        raise ValueError(f"kernel M takes repeat 1..{AUCTION_MAX_SLOTS - 1},"
                         f" got {repeat}")
    if n < 1 or m < (repeat + 1 if repeat > 1 else 1):
        raise ValueError(f"kernel M: {n} rows and {m} columns cannot be "
                         f"solved at repeat {repeat}")
    if auction_shared_bytes(n, m) > AUCTION_MAX_SHARED:
        raise ValueError(f"kernel M keeps at most {AUCTION_MAX_SHARED} bytes"
                         f" of a problem in shared memory; {n} x {m} needs "
                         f"{auction_shared_bytes(n, m)}")
    nv = n_valid.to(device=cost.device, dtype=torch.int32).contiguous()
    kernels.check(nv, torch.int32, (P,), "n_valid")
    col4row = torch.empty(P, n, dtype=torch.int32, device=cost.device)
    rounds = torch.empty(P, dtype=torch.int32, device=cost.device)
    if P:
        kernels.call("auction", cost.data_ptr(), nv.data_ptr(),
                     col4row.data_ptr(), rounds.data_ptr(), P, n, m,
                     int(repeat), float(eps_frac), int(max_iters),
                     torch.cuda.current_stream(cost.device).cuda_stream)
    return col4row, rounds


def auction(cost, n_valid, eps_frac: float = 0.002, max_iters: int = 3000):
    """Batched eps-optimal assignment: cost (P, n, m), n_valid (P,) rows
    to assign -> col4row (P, n) int32, -1 for rows past n_valid and for
    any row still unassigned after max_iters rounds (callers mask by it).
    Rows may exceed columns. CUDA tensors launch kernel M (or raise); CPU
    tensors take `auction_plain`."""
    if not cost.is_cuda:
        return auction_plain(cost, n_valid, eps_frac, max_iters)[0]
    col4row, _ = auction_launch(cost.float().contiguous(), n_valid, 1,
                                eps_frac, max_iters)
    auction.launches += 1
    return col4row


def auction_capacity(cost, n_valid, repeat: int, eps_frac: float = 0.002,
                     max_iters: int = 3000):
    """Batched capacity auction on the repeat-tiled layout (see
    `auction_capacity_plain`): cost (P, n, m) with n a multiple of
    `repeat` -> col4row (P, n) int32. CUDA tensors launch kernel M (or
    raise), counted on `auction.launches`; CPU tensors take the plain
    version."""
    if not cost.is_cuda:
        return auction_capacity_plain(cost, n_valid, repeat, eps_frac,
                                      max_iters)[0]
    col4row, _ = auction_launch(cost.float().contiguous(), n_valid, repeat,
                                eps_frac, max_iters)
    auction.launches += 1
    return col4row


auction.launches = 0
