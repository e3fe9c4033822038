"""Three-nearest-neighbour feature interpolation (torch counterpart of
`vdetr_tpu/ops/interpolate.py`; reference
third_party/pointnet2/_ext_src/src/interpolate_gpu.cu).

`three_nn`: for each unknown point, its 3 nearest known points in
ascending distance, the lower index first among equal distances (as
`lax.top_k`). `three_interpolate`: the inverse-distance weighted sum of
their features; its backward, a scatter-add, comes from autograd.
"""

from __future__ import annotations

import torch


def three_nn(unknown, known, known_valid=None):
    """unknown (B, n, 3); known (B, m, 3); known_valid (B, m) bool or
    None (invalid points at infinite distance) -> (dist, idx), both (B,
    n, 3), idx int32."""
    d2 = ((unknown[:, :, None, :] - known[:, None, :, :]) ** 2).sum(-1)
    if known_valid is not None:
        d2 = torch.where(known_valid[:, None, :], d2, torch.inf)
    d2, idx = torch.sort(d2, dim=-1, stable=True)
    return torch.sqrt(d2[..., :3]), idx[..., :3].to(torch.int32)


def three_interpolate(features, idx, weight):
    """features (B, C, m); idx (B, n, 3); weight (B, n, 3) -> (B, C, n)."""
    B, C, _ = features.shape
    n = idx.shape[1]
    flat = features.gather(2, idx.long().reshape(B, 1, n * 3).expand(
        -1, C, -1)).reshape(B, C, n, 3)
    return (flat * weight[:, None, :, :]).sum(-1)


def interpolate_weights(dist, eps: float = 1e-8):
    """Inverse-distance weights of `PointnetFPModule` (reference
    third_party/pointnet2/pointnet2_modules.py:386-391)."""
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(-1, keepdim=True)
