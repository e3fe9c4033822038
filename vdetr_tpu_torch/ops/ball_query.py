"""Fixed-radius ball query (torch counterpart of
`vdetr_tpu/ops/ball_query.py`; reference
third_party/pointnet2/_ext_src/src/ball_query_gpu.cu:12-57).

For each query center, the first `nsample` points in index order whose
squared distance is below radius^2; the slots past the hits repeat the
first hit; a center with no hit gets all zeros (the CUDA kernel leaves
its zeroed buffer as it is). JAX computes this in XLA, outside any
Pallas kernel, and so do these torch ops.
"""

from __future__ import annotations

import torch


def ball_query(radius: float, nsample: int, xyz, new_xyz, valid_mask=None):
    """xyz (B, N, 3) support points; new_xyz (B, npoint, 3) centers;
    valid_mask (B, N) bool or None (padded points never match). Returns
    (B, npoint, nsample) int32."""
    d2 = ((new_xyz[:, :, None, :] - xyz[:, None, :, :]) ** 2).sum(-1)
    within = d2 < radius * radius                        # (B, npoint, N)
    if valid_mask is not None:
        within = within & valid_mask[:, None, :]
    N = xyz.shape[1]
    # hits keep their index, misses become N; the first nsample in order
    cand = torch.where(within, torch.arange(N, device=xyz.device), N)
    first = torch.sort(cand, dim=-1).values[..., :nsample]
    idx = torch.where(first >= N, first[..., 0:1], first)
    idx = torch.where(within.any(dim=-1, keepdim=True), idx, 0)
    return idx.to(torch.int32)
