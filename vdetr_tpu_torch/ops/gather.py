"""Gather and grouping ops (torch counterpart of
`vdetr_tpu/ops/gather.py`; reference pointnet2 `gather_operation` /
`grouping_operation`, third_party/pointnet2/_ext_src/src/
sampling_gpu.cu:12-60 and group_points_gpu.cu:11-78): index gathers,
whose backward, a scatter-add, autograd gives as the CUDA grad kernels
compute it.
"""

from __future__ import annotations

import torch


def gather_operation(features, idx):
    """features (B, C, N); idx (B, m) int -> (B, C, m)."""
    idx = idx.long()[:, None, :].expand(-1, features.shape[1], -1)
    return features.gather(2, idx)


def grouping_operation(features, idx):
    """features (B, C, N); idx (B, npoint, nsample) int -> (B, C, npoint,
    nsample)."""
    B, C, _ = features.shape
    _, npoint, nsample = idx.shape
    flat = idx.long().reshape(B, 1, npoint * nsample).expand(-1, C, -1)
    return features.gather(2, flat).reshape(B, C, npoint, nsample)
