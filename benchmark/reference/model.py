"""The detector, plain (frozen copy of `vdetr_tpu_torch/models/vdetr.py`
and the plain FPS of `ops/fps.py`): voxelize at 1 cm, SparseResNet, FPN
to stride 4, FPS to the seeds, the seed class head and anchors, and the
decoder."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from benchmark.reference.decoder import (TransformerDecoder,
                                         box_parametrization_to_corners,
                                         class_margin)
from benchmark.reference.nets import FPNOutBlock, FPNUpBlock, GenericMLP, \
    SparseResNet
from benchmark.reference.sparse import voxelize

_SKIP_MAG = 1e-3
_INIT_DIST = 1e10


def _fma32(a, b, c):
    """float32 a * b + c rounded once (the float64 product is exact; the
    sum is rounded to odd, so that the rounding to float32 is correct)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _sq_norm(x, y, z):
    return _fma32(z, z, _fma32(y, y, x * x))


def fps(xyz, npoint: int):
    """Furthest point sampling from index 0: each step the point of the
    largest running min squared distance (fused multiply-adds, the first
    index on ties); points of squared norm <= 1e-3 are never picked."""
    B, N, _ = xyz.shape
    x, y, z = (xyz[..., i].contiguous() for i in range(3))
    skip = _sq_norm(x, y, z) <= _SKIP_MAG
    temp = torch.full((B, N), _INIT_DIST, dtype=xyz.dtype, device=xyz.device)
    idxs = torch.zeros(B, npoint, dtype=torch.int64, device=xyz.device)
    old = torch.zeros(B, 1, dtype=torch.int64, device=xyz.device)
    neg = torch.tensor(-1.0, dtype=xyz.dtype, device=xyz.device)
    for j in range(1, npoint):
        dx = x - x.gather(1, old)
        dy = y - y.gather(1, old)
        dz = z - z.gather(1, old)
        d2 = torch.minimum(_sq_norm(dx, dy, dz), temp)
        temp = torch.where(skip, temp, d2)
        old = torch.where(skip, neg, d2).argmax(dim=1, keepdim=True)
        idxs[:, j] = old[:, 0]
    return idxs


def _gather(x, idx):
    return x.gather(1, idx.reshape(idx.shape + (1,) * (x.ndim - 2))
                    .expand(idx.shape + x.shape[2:]))


class VDETR(nn.Module):
    def __init__(self, cfg, num_semcls: int, num_angle_bin: int,
                 mean_size_arr):
        super().__init__()
        c = self.cfg = cfg
        if c.depth not in (18, 34) or not c.use_fpn or c.compute_dtype != \
                "float32" or c.pos_for_key or not c.querypos_mlp:
            raise ValueError("the reference covers the BasicBlock depths, "
                             "the FPN, float32 and the published decoder")
        caps = c.stage_capacities()
        self.pre_encoder = SparseResNet(c.backbone_in_dim, c.depth,
                                        c.inplanes, c.num_stages, caps[1:])
        channels = [c.inplanes * 2 ** i for i in range(c.num_stages)]
        for i in range(c.num_stages - 1, c.layer_idx, -1):
            self.add_module(f"up_block_{i}",
                            FPNUpBlock(channels[i], channels[i - 1]))
        self.add_module(f"out_block_{c.layer_idx}",
                        FPNOutBlock(channels[c.layer_idx], c.enc_dim))
        self.encoder_to_decoder_projection = GenericMLP(
            c.enc_dim, [] if c.proj_nohid else [c.enc_dim], c.dec_dim,
            output_use_activation=True, output_use_norm=True,
            output_use_bias=False)
        self.decoder = TransformerDecoder(c, num_semcls, num_angle_bin)
        self.register_buffer(
            "mean_size_arr",
            torch.as_tensor(np.asarray(mean_size_arr, np.float32)),
            persistent=False)

    def encode(self, inputs):
        """Voxel grid to the seeds: (enc_xyz, enc_features, seed_valid,
        seed_inds)."""
        c = self.cfg
        pc = inputs["point_clouds"]
        point_valid = inputs.get("point_validity")
        if point_valid is None:
            point_valid = torch.ones(pc.shape[:2], dtype=torch.bool,
                                     device=pc.device)
        caps = c.stage_capacities()
        grid = voxelize(pc[..., :3], pc[..., :3], point_valid,
                        voxel_size=c.voxel_size, capacity=caps[0],
                        extent=c.grid_extent)
        stages = self.pre_encoder(grid)
        x = stages[-1]
        for i in range(c.num_stages - 1, c.layer_idx - 1, -1):
            if i < c.num_stages - 1:
                up = getattr(self, f"up_block_{i + 1}")(x, stages[i])
                x = stages[i].replace(
                    features=stages[i].features + up.features)
        out = getattr(self, f"out_block_{c.layer_idx}")(x)
        vox_xyz = out.world_xyz() * out.valid[..., None]
        seed_inds = fps(vox_xyz.contiguous(), c.preenc_npoints)
        return (_gather(vox_xyz, seed_inds), _gather(out.features, seed_inds),
                _gather(out.valid, seed_inds), seed_inds)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None, topk=None,
                proposals_only: bool = False, angle_cls=None, size_cls=None):
        """`topk`, `angle_cls` and `size_cls` (B, n_seeds), when given,
        replace the proposals' choice, the boxes' angle classes and the
        seeds' classes that pick their size priors; `proposals_only`:
        stop at the choice of proposals."""
        c = self.cfg
        dims_min = inputs["point_cloud_dims_min"]
        dims_max = inputs["point_cloud_dims_max"]
        enc_xyz, enc_features, seed_valid, seed_inds = self.encode(inputs)
        enc_features = self.encoder_to_decoder_projection(enc_features)
        point_cls_logits = self.decoder.pointcls_heads(enc_features,
                                                       generator)
        if size_cls is None:
            class_idx = torch.sigmoid(point_cls_logits).argmax(dim=-1)
        else:
            class_idx = size_cls
        logits = point_cls_logits.detach()
        prior_margin = (torch.zeros((), device=logits.device) if c.hard_anchor
                        else class_margin(logits, torch.sigmoid(logits),
                                          class_idx))
        size_per_class = (torch.ones_like(self.mean_size_arr)
                          if c.hard_anchor else self.mean_size_arr)
        size_un = size_per_class[class_idx]
        scene = (dims_max - dims_min)[:, None, :]
        enc_box_predictions = {
            "point_cls_logits": point_cls_logits,
            "center_unnormalized": enc_xyz,
            "center_normalized": (enc_xyz - dims_min[:, None, :]) / scene,
            "size_unnormalized": size_un,
            "size_normalized": size_un / scene,
        }
        enc_box_predictions["box_corners"] = box_parametrization_to_corners(
            enc_xyz, size_un, torch.zeros_like(enc_xyz[..., 0]))
        box_predictions = self.decoder(
            enc_features, enc_xyz, [dims_min, dims_max], enc_box_predictions,
            enc_valid=seed_valid, generator=generator, topk=topk,
            proposals_only=proposals_only, angle_cls=angle_cls)
        box_predictions["seed_valid"] = seed_valid
        box_predictions["size_cls"] = None if c.hard_anchor else class_idx
        box_predictions["prior_margin"] = prior_margin
        box_predictions["seed_inds"] = seed_inds
        box_predictions["seed_xyz"] = enc_xyz
        box_predictions["enc_outputs"] = enc_box_predictions
        return box_predictions
