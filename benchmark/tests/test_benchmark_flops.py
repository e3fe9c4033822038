"""The sparse convs' flop count equals a brute-force count over the
voxel sites, on a tiny configuration."""

import itertools

import numpy as np
import torch

from benchmark import flops, harness
from benchmark.reference.config import ref_config
from tiny import tiny_cell


def _sites(points, voxel, align=32):
    """The occupied voxels of each level, as sets of integer triples."""
    c = np.floor(points * np.float32(1.0 / np.float32(voxel))).astype(
        np.int64)
    c -= (c.min(0) // align) * align
    levels = [set(map(tuple, c))]
    for _ in range(5):
        levels.append({(x // 2, y // 2, z // 2) for x, y, z in levels[-1]})
    return levels


def _hits(queries, table, scale):
    offs = list(itertools.product((-1, 0, 1), repeat=3))
    return sum((scale * x + i, scale * y + j, scale * z + k) in table
               for x, y, z in queries for i, j, k in offs)


def test_conv_flops_by_brute_force():
    cell = tiny_cell("scannet_r34.train_b8")
    cfg = ref_config(cell["config"])
    feed = harness.Feed(cell, 11, torch.device("cpu"))
    batch = feed[0]
    work = flops.step_work(cfg, batch, train=False)
    expect = 0.0
    ch = [cfg.inplanes * 2 ** i for i in range(cfg.num_stages)]
    blocks = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}[cfg.depth]
    for b in range(batch["point_clouds"].shape[0]):
        lv = _sites(batch["point_clouds"][b].numpy(), cfg.voxel_size)
        assert all(len(s) <= cap for s, cap in
                   zip(lv, cfg.stage_capacities()))
        expect += 2 * _hits(lv[1], lv[0], 2) * 3 * cfg.inplanes
        for i in range(cfg.num_stages):
            cin = cfg.inplanes if i == 0 else ch[i - 1]
            fine, here = lv[i + 1], lv[i + 2]
            sub = _hits(here, here, 1)
            expect += 2 * _hits(here, fine, 2) * cin * ch[i]
            expect += 2 * sum((2 * x, 2 * y, 2 * z) in fine
                              for x, y, z in here) * cin * ch[i]
            expect += 2 * sub * ch[i] * ch[i] * (1 + 2 * (blocks[i] - 1))
        for i in range(cfg.num_stages - 2, -1, -1):
            here = lv[i + 2]
            expect += 2 * len(here) * ch[i + 1] * ch[i]
            expect += 2 * _hits(here, here, 1) * ch[i] * ch[i]
        expect += 2 * _hits(lv[2], lv[2], 1) * ch[0] * cfg.enc_dim
    assert work.flops["sparse_conv"] == expect


def test_train_is_three_forwards_but_the_stem():
    cell = tiny_cell("scannet_r34.train_b8")
    cfg = ref_config(cell["config"])
    batch = harness.Feed(cell, 11, torch.device("cpu"))[0]
    ev = flops.step_work(cfg, batch, train=False)
    tr = flops.step_work(cfg, batch, train=True)
    assert tr.flops["dense"] == 3 * ev.flops["dense"]
    assert tr.flops["rpe_attn"] == 3 * ev.flops["rpe_attn"]
    assert 2 * ev.flops["sparse_conv"] < tr.flops["sparse_conv"] \
        < 3 * ev.flops["sparse_conv"]
    for w in (ev, tr):
        for layer, b in w.bound.items():
            assert b >= w.flops[layer] / flops.PEAK_FLOPS["float32"]
