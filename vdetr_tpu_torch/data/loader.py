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
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


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


def prefetch_loader(dataset, batch_size: int, shuffle: bool = True,
                    seed: int = 0, drop_last: bool = True,
                    pad_last: bool = False, num_workers: int = 0,
                    prefetch_batches: int = 2) -> Iterator:
    """Yields collated batches; with num_workers > 0, up to
    `prefetch_batches` future batches are being fetched concurrently while
    the consumer runs the current step."""
    plan = _batch_indices(len(dataset), batch_size, shuffle, seed,
                          drop_last, pad_last)
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
