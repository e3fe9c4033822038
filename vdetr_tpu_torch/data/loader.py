"""Prefetching data loader, a copy of `vdetr_tpu/data/loader.py`.

The reference feeds the GPU from 8 DataLoader worker processes per rank
(reference main.py:157, 526-546). Here a thread pool fetches and collates
batches ahead of the consumer (numpy augmentation releases the GIL for
the big array ops), keeping the accelerator fed when the step time drops
to milliseconds. `num_workers <= 0` degrades to the synchronous path.

Batch contract matches data/synthetic.make_loader: optional shuffling,
drop_last, and pad_last (static batch shape + per-sample `sample_valid`
mask so tail scans are scored, never dropped). The batches and their
order are the JAX package's for the same seed.

Under data parallelism (`rank`, `world`) every rank draws the plan of
the global batch and fetches only its own rows of each batch (rank r of
n: rows [r b, (r + 1) b) of n b, `parallel.dist.rows`), so that the
ranks' rows together are the batch one process would load; `pad_last`
pads the global batch, and every rank's rows keep the static shape.

Under key sharding (`seq_rank`, `seq_world`: rank (d, s) of a D x S grid
takes `rank=d, world=D`) each rank keeps the contiguous block s of S of
every scene's points (`seq_block`), JAX's `P(data, seq)`; the GT fields
and the scene extents stay whole.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from vdetr_tpu_torch.parallel.dist import rows


def _batch_indices(n, batch_size, shuffle, seed, drop_last, pad_last):
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    if pad_last:
        drop_last = False
    end = n - (n % batch_size) if drop_last else n
    out = []
    for i in range(0, end, batch_size):
        take = idx[i:i + batch_size]
        nvalid = len(take)
        if pad_last and nvalid < batch_size:
            take = np.concatenate([take, np.full(batch_size - nvalid,
                                                 take[-1])])
        out.append((take, nvalid))
    return out


def _collate(samples, nvalid, pad_last):
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    if pad_last:
        valid = np.zeros(len(samples), bool)
        valid[:nvalid] = True
        batch["sample_valid"] = valid
    return batch


def _shard(plan, batch_size, rank, world):
    """Rank `rank`'s rows of each batch of `plan`, with their count of
    valid rows."""
    mine = rows(batch_size, rank, world)
    return [(take[mine], min(max(nvalid - mine.start, 0), len(take[mine])))
            for take, nvalid in plan]


# the per-point fields that key sharding splits (vdetr_tpu/train/
# engine.py:111-120); every other field is the whole scene's
POINT_KEYS = ("point_clouds", "point_validity")


def seq_block(batch, s: int, S: int):
    """`batch` with block `s` of `S` contiguous blocks of its points (the
    point count must divide evenly)."""
    out = dict(batch)
    for k in POINT_KEYS:
        if k in batch:
            out[k] = batch[k][:, rows(batch[k].shape[1], s, S)]
    return out


def prefetch_loader(dataset, batch_size: int, shuffle: bool = True,
                    seed: int = 0, drop_last: bool = True,
                    pad_last: bool = False, num_workers: int = 0,
                    prefetch_batches: int = 2, rank: int = 0,
                    world: int = 1, seq_rank: int = 0,
                    seq_world: int = 1) -> Iterator:
    """Yields collated batches; with num_workers > 0, up to
    `prefetch_batches` future batches are being fetched concurrently while
    the consumer runs the current step. `batch_size` is the global batch:
    with `world` > 1 each batch holds rank `rank`'s share of it, and with
    `seq_world` > 1 block `seq_rank` of its points (`seq_block`)."""
    if seq_world > 1:
        for b in prefetch_loader(dataset, batch_size, shuffle, seed,
                                 drop_last, pad_last, num_workers,
                                 prefetch_batches, rank, world):
            yield seq_block(b, seq_rank, seq_world)
        return
    plan = _batch_indices(len(dataset), batch_size, shuffle, seed,
                          drop_last, pad_last)
    if world > 1:
        if not (drop_last or pad_last):
            raise ValueError("a short last batch does not split over the "
                             "ranks: pass drop_last or pad_last")
        plan = _shard(plan, batch_size, rank, world)
    if num_workers <= 0:
        for take, nvalid in plan:
            yield _collate([dataset[int(j)] for j in take], nvalid, pad_last)
        return

    with ThreadPoolExecutor(max_workers=num_workers) as pool:

        def fetch(args):
            take, nvalid = args
            samples = list(pool.map(dataset.__getitem__,
                                    [int(j) for j in take]))
            return _collate(samples, nvalid, pad_last)

        pending = collections.deque()
        it = iter(plan)
        # a dedicated scheduler slot per in-flight batch; sample fetches
        # fan out over the shared pool
        sched = ThreadPoolExecutor(max_workers=max(prefetch_batches, 1))
        try:
            for args in it:
                pending.append(sched.submit(fetch, args))
                if len(pending) > prefetch_batches:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            sched.shutdown(wait=False, cancel_futures=True)
