"""Box sets for holding kernel N (the eval step's greedy same-class NMS)
to its plain loop at the edges where a scan could part from the loop:
exact score ties, pairs of boxes exactly at the IoU threshold, holes in
`valid` (`nms_cases`), and chains in which every box's fate hangs on the
one before it (`nms_chain`). Used by `chip_smoke.py` and the tests;
numpy only.
"""

from __future__ import annotations

import numpy as np


def nms_cases(rng: np.random.RandomState, B: int, K: int):
    """(aabbs (B, K, 6) float32, scores (B, K) float32, classes (B, K)
    int32, valid (B, K) bool).

    Half the boxes have continuous corners and sizes 0.1-1.5 m; the other
    half lie on a 1/8 m lattice, so their areas and overlaps are exact and
    coincide often. Scores are multiples of 1/64 for half the boxes (many
    exact ties) and continuous for the rest. Every eighth box is placed
    against the box before it, same class and a score no higher, so that
    their overlap is exactly 0.25, the published threshold, in f32: a
    box (2, 1, 1) s against (3, 1, 1) s shifted by s along x (IoU 1/4),
    or against (4, 1, 1) s shifted by s (overlap over its own area, the
    old type's, 1/4), with s a power of two. One box in ten is not valid.
    The boxes fill a cube whose volume grows with K (3 m a side at 1024
    boxes), so that many same-class boxes overlap at every K.
    """
    extent = max(3.0 * (K / 1024) ** (1 / 3), 1.0)
    lo = rng.rand(B, K, 3) * extent
    size = 0.1 + rng.rand(B, K, 3) * 1.4
    lattice = rng.rand(B, K) < 0.5
    lo[lattice] = rng.randint(0, int(extent * 8), (int(lattice.sum()), 3)) / 8
    size[lattice] = rng.randint(1, 12, (int(lattice.sum()), 3)) / 8
    scores = rng.rand(B, K)
    tied = rng.rand(B, K) < 0.5
    scores[tied] = np.floor(scores[tied] * 64) / 64
    classes = rng.randint(0, 3, (B, K))  # three classes: many same-class pairs
    for b in range(B):
        for j in range(1, K, 8):
            i = j - 1
            s = 2.0 ** rng.randint(-3, 0)
            lo[b, i] = rng.randint(0, int(extent * 4), 3) / 4
            size[b, i] = (2 * s, s, s)
            lo[b, j] = lo[b, i] + (s, 0, 0)
            size[b, j] = ((3 if rng.rand() < 0.5 else 4) * s, s, s)
            classes[b, j] = classes[b, i]
            scores[b, j] = scores[b, i] * (1.0 if rng.rand() < 0.5 else 0.5)
    aabbs = np.concatenate([lo, lo + size], axis=-1).astype(np.float32)
    valid = rng.rand(B, K) >= 0.1
    return (aabbs, scores.astype(np.float32), classes.astype(np.int32),
            valid)


def nms_chain(rng: np.random.RandomState, B: int, K: int):
    """(aabbs, scores, classes, valid) as `nms_cases` returns them: a
    chain of K unit cubes of one class, each shifted 0.5 m along x from
    the one before it and scored below it, stored in a random order. Each
    cube overlaps the next by 1/3 (and by 1/2 over its own volume, the old
    type's), both above the published 0.25, and the one after that not at
    all, so the loop keeps every other cube: the fate of the i-th depends
    on all i - 1 before it, a dependency chain as long as the set."""
    aabbs = np.zeros((B, K, 6), np.float32)
    scores = np.zeros((B, K), np.float32)
    for b in range(B):
        at = rng.permutation(K)  # the chain's i-th cube is stored at at[i]
        x = 0.5 * np.arange(K)
        aabbs[b, at] = np.stack([x, 0 * x, 0 * x, x + 1, 0 * x + 1,
                                 0 * x + 1], -1)
        scores[b, at] = 1.0 - np.arange(K) / K
    return (aabbs, scores, np.zeros((B, K), np.int32),
            np.ones((B, K), bool))
