"""Vertex relative-position-encoding utilities (torch counterpart of
`vdetr_tpu/ops/rpe.py`; reference models/vdetr_transformer.py:701-731).

For each of the 8 box corners of a query, the delta to every key point
is log-quantized and samples a small learned bias table trilinearly,
like torch `F.grid_sample(align_corners=False, padding_mode="zeros")` on
a 5D input: sample component 0 indexes the table's LAST grid axis.
"""

from __future__ import annotations

import numpy as np
import torch


def log_quantize(delta, log_scale: float, max_value: float):
    """sign(d) * log2(|d| * log_scale + 1) / log2(8) / max_value
    (reference vdetr_transformer.py:722-723)."""
    q = torch.sign(delta) * torch.log2(torch.abs(delta) * log_scale + 1.0)
    return q / float(np.log2(8.0)) / max_value


def make_coords_table(max_value: float, num_points: int) -> np.ndarray:
    """(num_points^3, 3) float32 grid of linspace(-max, max) triples, t0
    slowest .. t2 fastest (reference vdetr_transformer.py:677-682)."""
    lin = np.linspace(-max_value, max_value, num_points, dtype=np.float32)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1)
    return g.reshape(-1, 3)


def trilinear_sample(table, p0, p1, p2):
    """table (n, n, n, H) on the grid (axes d, h, w); p0/p1/p2
    broadcast-compatible (...,) sample components in [-1, 1], component
    0 -> w, 1 -> h, 2 -> d. Out-of-range taps contribute zero. Returns
    (H, ...), heads first."""
    n = table.shape[0]
    H = table.shape[-1]
    flat = table.reshape(-1, H).t().contiguous()     # (H, n^3)

    def to_idx(p):
        # align_corners=False: continuous index = ((p + 1) * n - 1) / 2
        return ((p + 1.0) * n - 1.0) * 0.5

    iw, ih, id_ = torch.broadcast_tensors(to_idx(p0), to_idx(p1),
                                          to_idx(p2))
    fw, fh, fd = torch.floor(iw), torch.floor(ih), torch.floor(id_)
    ww, wh, wd = iw - fw, ih - fh, id_ - fd
    fw, fh, fd = fw.long(), fh.long(), fd.long()
    out = table.new_zeros((H,) + iw.shape)
    for dw in (0, 1):
        for dh in (0, 1):
            for dd in (0, 1):
                cw, ch, cd = fw + dw, fh + dh, fd + dd
                inb = ((cw >= 0) & (cw < n) & (ch >= 0) & (ch < n)
                       & (cd >= 0) & (cd < n))
                w = ((ww if dw else 1.0 - ww) * (wh if dh else 1.0 - wh)
                     * (wd if dd else 1.0 - wd)) * inb
                idx = ((cd.clamp(0, n - 1) * n + ch.clamp(0, n - 1)) * n
                       + cw.clamp(0, n - 1))
                out = out + flat[:, idx] * w
    return out
