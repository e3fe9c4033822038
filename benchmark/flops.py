"""The useful work of a step and its bounds on one H100, the benchmark's
own count (rewritten in torch from the top-level `tools/flops.py`, which
imports the JAX package; `attention_flops` is a frozen copy of
`vdetr_tpu_torch/tools/rpe_ablate.py:attention_flops`).

Counted, at 2 flops a multiply-add:
- each sparse conv as 2 x (row, offset) hits x C_in x C_out, the hits
  taken from the reference's own voxel grids and neighbour maps of the
  batch; the 1x1 downsample and the kernel-2 transpose convs by their
  rows;
- the dense layers, the self-attention products and the RPE
  cross-attention (`attention_flops`, 8 taps) from their shapes;
- a training step as three times the forward (dX and dW), the stem's
  conv as two (its input needs no gradient).
Not counted: elementwise work, norms, FPS, sorts, the matcher and NMS.

Bytes: each input read once and each output written once. A bound is the
larger of the flops at the peak of the configuration's precision and the
bytes at the memory's bandwidth, whatever kernel implements the work:
for float32 configurations 495 TFLOP/s, dense TF32 on the tensor cores,
which no float32-accurate form beats.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.sparse import (downsample_grid, lookup,
                                        neighbour_map, pack_keys, voxelize,
                                        KEY_SENTINEL)

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def attention_flops(pairs: int, heads: int, hd: int, taps: int) -> int:
    """Per (head, query, key) the q.k and p.v products (4 hd) and the
    softmax (~4); per (query, key) pair and corner `taps` table
    multiply-adds of all heads (2 per head)."""
    return pairs * heads * (4 * hd + 4) + pairs * 8 * taps * heads * 2


class Work:
    """Flops and bounds (s) by layer: "sparse_conv", "rpe_attn",
    "dense"."""

    def __init__(self):
        self.flops: Dict[str, float] = {}
        self.bound: Dict[str, float] = {}

    def add(self, layer: str, flops: float, nbytes: float, peak: float):
        self.flops[layer] = self.flops.get(layer, 0.0) + flops
        self.bound[layer] = self.bound.get(layer, 0.0) + max(
            flops / peak, nbytes / HBM_BYTES_PER_S)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())


def _hits(nbr, q_valid, v_in):
    return int(((nbr != v_in) & q_valid[:, None, :]).sum())


@torch.no_grad()
def step_work(cfg, batch: Dict[str, torch.Tensor], train: bool) -> Work:
    """The work of one step on `batch` (device tensors) under `cfg` (the
    reference's config)."""
    peak = PEAK_FLOPS[cfg.compute_dtype]
    w = Work()
    passes = 3 if train else 1
    pc = batch["point_clouds"]
    B = pc.shape[0]
    caps = cfg.stage_capacities()
    grid = voxelize(pc[..., :3], pc[..., :3], batch["point_validity"],
                    cfg.voxel_size, caps[0], cfg.grid_extent)
    grids = [grid]
    for cap in caps[1:]:
        grids.append(downsample_grid(grids[-1], cap))
    valid = [int(g.valid.sum()) for g in grids]

    def conv(hits, cin, cout, v_in, v_out, k, first=False):
        n = 2 if (train and first) else passes
        flops = 2.0 * hits * cin * cout * n
        fwd = (v_in * cin + k * cin * cout + v_out * cout) * F32
        bwd = (v_out * cout + k * cin * cout + v_in * cin) * F32
        w.add("sparse_conv", flops, fwd + (n - 1) * bwd, peak)

    def strided(lv):
        gin, gout = grids[lv], grids[lv + 1]
        return _hits(neighbour_map(gin.keys, gout.coords * 2, gout.valid,
                                   gin.extent), gout.valid, gin.keys.shape[1])

    def sub(lv):
        g = grids[lv]
        return _hits(neighbour_map(g.keys, g.coords, g.valid, g.extent),
                     g.valid, g.keys.shape[1])

    def down1(lv):
        gin, gout = grids[lv], grids[lv + 1]
        qk = torch.where(gout.valid, pack_keys(gout.coords * 2, gin.extent),
                         KEY_SENTINEL)
        return int((lookup(gin.keys, qk) != gin.keys.shape[1]).sum())

    blocks = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}[cfg.depth]
    ch = [cfg.inplanes * 2 ** i for i in range(cfg.num_stages)]
    conv(strided(0), cfg.backbone_in_dim, cfg.inplanes, valid[0], valid[1],
         27, first=True)
    subs = {}
    for i in range(cfg.num_stages):
        cin = cfg.inplanes if i == 0 else ch[i - 1]
        lv = i + 2  # raw, stem, stage 1, ...
        subs[lv] = sub(lv)
        conv(strided(lv - 1), cin, ch[i], valid[lv - 1], valid[lv], 27)
        conv(down1(lv - 1), cin, ch[i], valid[lv - 1], valid[lv], 1)
        conv(subs[lv], ch[i], ch[i], valid[lv], valid[lv], 27)
        for _ in range(blocks[i] - 1):
            for _ in range(2):
                conv(subs[lv], ch[i], ch[i], valid[lv], valid[lv], 27)
    for i in range(cfg.num_stages - 2, cfg.layer_idx - 1, -1):
        lv = i + 2
        conv(valid[lv], ch[i + 1], ch[i], valid[lv + 1], valid[lv], 8)
        conv(subs[lv], ch[i], ch[i], valid[lv], valid[lv], 27)
    lv = cfg.layer_idx + 2
    conv(subs[lv], ch[cfg.layer_idx], cfg.enc_dim, valid[lv], valid[lv], 27)

    # ---- the decoder ----
    S, Q, D, F = cfg.preenc_npoints, cfg.nqueries, cfg.dec_dim, \
        cfg.dec_ffn_dim
    H = cfg.dec_nhead
    hd = D // H

    def dense(rows, cin, cout):
        w.add("dense", 2.0 * rows * cin * cout * passes,
              (rows * cin + cin * cout + rows * cout) * F32 * passes, peak)

    def heads(rows, ncls, nbins):
        for out in (ncls, 3, 3, nbins, nbins):
            dense(rows, D, D)
            dense(rows, D, D)
            dense(rows, D, out)

    ncls = cfg.num_semcls
    nbins = cfg.num_angle_bin
    dense(B * S, cfg.enc_dim, D)                     # projection
    dense(B * S, D, D), dense(B * S, D, D), dense(B * S, D, ncls)
    dense(B * S, D, F), dense(B * S, F, D)           # first FFN layer
    heads(B * S, 1 if cfg.is_bilable else ncls, nbins)
    n = cfg.rpe_table_points ** 3
    for _ in range(cfg.dec_nlayers - 1):
        dense(B * Q, 6, D), dense(B * Q, D, D)       # query position
        dense(B * Q, D, 3 * D)                       # self-attention
        w.add("dense", 4.0 * B * Q * Q * D * passes,
              3 * B * Q * D * F32 * passes, peak)
        dense(B * Q, D, D)
        dense(B * Q, D, D)                           # cross-attn q
        dense(B * S, D, 2 * hd)                      # its shared k, v
        for _ in range(8):                           # the corner tables
            dense(n, 3, cfg.rpe_dim), dense(n, cfg.rpe_dim, H)
        pairs = B * Q * S
        w.add("rpe_attn", float(attention_flops(pairs, H, hd, 8)) * passes,
              (B * Q * D + 2 * B * S * hd + B * Q * 24 + B * S * 3
               + 8 * n * H + B * Q * D) * F32 * passes, peak)
        dense(B * Q, D, D)                           # its projection
        dense(B * Q, D, F), dense(B * Q, F, D)       # FFN
        heads(B * Q, ncls, nbins)
    return w
