"""The port's auction matchers against `vdetr_tpu.ops.hungarian` on the CPU.

`auction_plain` and `auction_capacity_plain` (what a CPU tensor runs, and
what kernel M is held to on the card) must give JAX's `col4row` bit for
bit (tolerance 0) on the cases of `tests/test_hungarian.py`: random
costs, the sentinel-padded training regime, duplicated rows, the capacity
layout, exact ties, rows and classes with no valid entry, more GT slots
than proposals, a batch of problems that finish in different rounds, and
a problem cut at `max_iters`. Beside them: the criterion's assignment
from `col4row` against JAX's, and kernel M's bid key (order-preserving
bits above the bidder) against JAX's scatter-max then scatter-min.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetr_tpu.ops.hungarian import auction as j_auction
from vdetr_tpu.ops.hungarian import auction_capacity as j_capacity
from vdetr_tpu.train.criterion import SetCriterion as JaxCriterion
from vdetr_tpu_torch.ops.hungarian import (auction, auction_capacity,
                                           auction_capacity_plain,
                                           auction_plain)
from vdetr_tpu_torch.train.criterion import SetCriterion


def jax_auction(cost, n_valid, repeat=None, **kw):
    c, n = jnp.asarray(cost), jnp.asarray(n_valid)
    if repeat is None:
        return np.asarray(j_auction(c, n, **kw))
    return np.asarray(j_capacity(c, n, repeat, **kw))


def port_auction(cost, n_valid, repeat=None, **kw):
    c, n = torch.from_numpy(cost), torch.from_numpy(np.asarray(n_valid))
    if repeat is None:
        return auction_plain(c, n, **kw)
    return auction_capacity_plain(c, n, repeat, **kw)


def tiled(base, repeat, slots):
    """The training layout: row r < g * repeat copies class r % g, the
    rest 1e6 sentinels."""
    g, m = base.shape
    cost = np.full((slots * repeat, m), 1e6, np.float32)
    for d in range(repeat):
        cost[d * g:(d + 1) * g] = base
    return cost


def plain_cases():
    rng = np.random.RandomState(0)
    out = {
        "random_8x20": ((rng.randn(1, 8, 20) * 3).astype(np.float32), [8]),
        "random_40x150": ((rng.randn(1, 40, 150) * 3).astype(np.float32),
                          [40]),
    }
    base = (rng.randn(6, 64) * 2).astype(np.float32)
    out["sentinel_padded"] = (tiled(base, 5, 8)[None], [30])
    base = (rng.randn(12, 64) * 2).astype(np.float32)
    out["duplicated_rows"] = (np.tile(base, (5, 1))[None], [60])
    out["ties"] = (np.round(rng.rand(2, 30, 40) * 3).astype(np.float32),
                   [30, 17])
    out["all_equal"] = (np.ones((1, 12, 16), np.float32), [12])
    out["zero_valid_rows"] = (rng.rand(2, 5, 9).astype(np.float32), [0, 5])
    # K > nprop: the criterion pads 1e6 dummy columns up to K
    c = np.full((1, 24, 24), 1e6, np.float32)
    c[0, :, :16] = rng.randn(24, 16).astype(np.float32)
    out["more_slots_than_proposals"] = (c, [20])
    out["batch_of_rounds"] = ((rng.randn(4, 16, 64)).astype(np.float32),
                              [16, 3, 0, 9])
    out["single_column"] = (rng.randn(2, 3, 1).astype(np.float32), [3, 1])
    return out


def capacity_cases():
    rng = np.random.RandomState(1)
    out = {}
    base = (rng.randn(7, 64) * 3).astype(np.float32)
    out["expanded_optimum"] = (tiled(base, 5, 12)[None], [35], 5)
    base = (rng.randn(5, 32) * 2).astype(np.float32)
    out["class_consistency"] = (np.concatenate([base] * 3)[None], [15], 3)
    base = np.round(rng.rand(6, 40) * 2).astype(np.float32)
    out["ties"] = (tiled(base, 5, 8)[None], [30], 5)
    out["all_equal"] = (tiled(np.ones((4, 24), np.float32), 2, 6)[None],
                        [8], 2)
    out["zero_valid_rows"] = (tiled(rng.rand(3, 20).astype(np.float32), 2,
                                    4)[None], [0], 2)
    c = np.full((1, 30, 30), 1e6, np.float32)
    c[0, :18, :20] = tiled(rng.randn(6, 20).astype(np.float32), 3, 6)[:18]
    out["more_slots_than_proposals"] = (c, [18], 3)
    b = [tiled((rng.randn(g, 48) * 2).astype(np.float32), 4, 6)
         for g in (6, 2, 0, 5)]
    out["batch_of_rounds"] = (np.stack(b), [24, 8, 0, 20], 4)
    return out


@pytest.mark.parametrize("name", sorted(plain_cases()))
def test_plain_auction_equals_jax(name):
    cost, nv = plain_cases()[name]
    col4row, rounds = port_auction(cost, nv)
    np.testing.assert_array_equal(col4row.numpy(), jax_auction(cost, nv))
    assert col4row.dtype == torch.int32
    assert (rounds[torch.tensor(nv) == 0] == 0).all()


@pytest.mark.parametrize("name", sorted(capacity_cases()))
def test_capacity_auction_equals_jax(name):
    cost, nv, repeat = capacity_cases()[name]
    col4row, rounds = port_auction(cost, nv, repeat)
    np.testing.assert_array_equal(col4row.numpy(),
                                  jax_auction(cost, nv, repeat))
    assert (rounds[torch.tensor(nv) == 0] == 0).all()


@pytest.mark.parametrize("repeat", [None, 5])
def test_auction_cut_at_max_iters_equals_jax(repeat):
    """Duplicated rows need hundreds of rounds: cut at 7, rows still
    unassigned come back -1, as in JAX."""
    base = (np.random.RandomState(2).randn(12, 64) * 2).astype(np.float32)
    cost = np.tile(base, (5, 1))[None]
    col4row, rounds = port_auction(cost, [60], repeat, max_iters=7)
    np.testing.assert_array_equal(
        col4row.numpy(), jax_auction(cost, [60], repeat, max_iters=7))
    assert int(rounds[0]) == 7 and (col4row < 0).any()


def test_cpu_entry_points_take_the_plain_versions():
    cost, nv, repeat = capacity_cases()["expanded_optimum"]
    c, n = torch.from_numpy(cost), torch.tensor(nv)
    before = auction.launches
    np.testing.assert_array_equal(auction_capacity(c, n, repeat).numpy(),
                                  jax_auction(cost, nv, repeat))
    np.testing.assert_array_equal(auction(c, n).numpy(),
                                  jax_auction(cost, nv))
    assert auction.launches == before  # only a kernel launch counts


def test_assignment_from_col4row_equals_jax():
    rng = np.random.RandomState(3)
    col4row = np.full((3, 10), -1, np.int32)
    for b, k in enumerate((10, 4, 0)):
        col4row[b, :k] = rng.choice(14, k, replace=False)  # some >= nprop
    got = SetCriterion.assignment_from_col4row(torch.from_numpy(col4row), 12)
    want = JaxCriterion.assignment_from_col4row(jnp.asarray(col4row), 12)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def order_bits(x):
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def test_kernel_bid_key_is_scatter_max_then_lowest_bidder():
    """Kernel M keeps, per column, the max of (order_bits(bid) << 32) |
    (0xffffffff - bidder): the best bid, then the lowest bidder among
    equal bids, whatever the order of arrival; JAX's rounds take col_best
    by scatter-max and the winner by scatter-min over the bidders at it."""
    rng = np.random.RandomState(4)
    for _ in range(20):
        bids = np.round(rng.rand(64) * 4).astype(np.float32) + np.float32(
            rng.choice([0, 1e-7, 3.5e3]))
        cols = rng.randint(0, 16, 64)
        who = rng.permutation(64)
        keys = (order_bits(bids) << np.uint64(32)) | (
            np.uint64(0xFFFFFFFF) - who.astype(np.uint64))
        for j in np.unique(cols):
            at = cols == j
            best = keys[at].max()
            price = np.uint32(best >> np.uint64(32))
            price = np.where(price & 0x80000000, price & 0x7FFFFFFF,
                             ~price).astype(np.uint32).view(np.float32)
            assert price == bids[at].max()
            assert 0xFFFFFFFF - int(best & np.uint64(0xFFFFFFFF)) == \
                who[at][bids[at] == bids[at].max()].min()
