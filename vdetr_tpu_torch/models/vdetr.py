"""VDETR: the full detector in eval mode (torch counterpart of
`vdetr_tpu/models/vdetr.py`; reference models/model_vdetr.py).

Pipeline: voxelize @ 1 cm -> SparseResNet34 -> FPN top-down to stride 4
-> furthest-point-sample 4096 seeds -> seed class head + anchor boxes ->
TransformerDecoder (top-1024 proposals, 8 RPE cross-attention layers).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.geometry.boxes import box_parametrization_to_corners
from vdetr_tpu_torch.models.backbone import (FPNOutBlock, FPNUpBlock,
                                             SparseResNet)
from vdetr_tpu_torch.models.mlp import GenericMLP
from vdetr_tpu_torch.models.transformer import (FOCAL_PRIOR_BIAS,
                                                TransformerDecoder)
from vdetr_tpu_torch.ops.fps import furthest_point_sample
from vdetr_tpu_torch.ops.voxelize import voxelize


def _gather(x, idx):
    """x (B, N, ...) rows at idx (B, M) -> (B, M, ...)."""
    return x.gather(1, idx.reshape(idx.shape + (1,) * (x.ndim - 2))
                    .expand(idx.shape + x.shape[2:]))


class VDETR(nn.Module):
    def __init__(self, cfg: VDETRConfig, num_semcls: int, num_angle_bin: int,
                 mean_size_arr):
        super().__init__()
        c = cfg
        self.cfg = c
        self.num_semcls = num_semcls
        caps = c.stage_capacities()
        self.pre_encoder = SparseResNet(
            c.backbone_in_dim, depth=c.depth, inplanes=c.inplanes,
            num_stages=c.num_stages, stem_bn=c.stem_bn,
            stage_capacities=caps[1:])
        channels = [c.inplanes * 2 ** i for i in range(c.num_stages)]
        for i in range(c.num_stages - 1, c.layer_idx, -1):
            if c.use_fpn:
                # up_block_{i} lifts stage i to the sites of stage i - 1
                self.add_module(f"up_block_{i}", FPNUpBlock(
                    channels[i], channels[i - 1],
                    woexpand_conv=c.woexpand_conv,
                    generative_capacity=caps[i]))
        self.add_module(f"out_block_{c.layer_idx}", FPNOutBlock(
            channels[c.layer_idx], c.enc_dim))
        self.encoder_to_decoder_projection = GenericMLP(
            c.enc_dim, [] if c.proj_nohid else [c.enc_dim], c.dec_dim,
            output_use_activation=True, output_use_norm=True,
            output_use_bias=False)
        self.decoder = TransformerDecoder(c, num_semcls, num_angle_bin)
        self.register_buffer(
            "mean_size_arr",
            torch.as_tensor(np.asarray(mean_size_arr, np.float32)),
            persistent=False)

    def _backbone_feats(self, point_clouds):
        c = self.cfg
        if c.use_color and c.xyz_color:
            return point_clouds
        if c.use_color:
            return point_clouds[..., 3:]
        if c.use_normals:
            return point_clouds
        return point_clouds[..., :3]

    def forward(self, inputs: Dict[str, torch.Tensor], debug_stop: int = 0):
        """inputs: point_clouds (B, N, D), point_cloud_dims_min/max (B, 3),
        optional point_validity (B, N) bool. debug_stop k > 0 returns the
        digest the JAX model returns after stage k (1 voxelize, 2
        backbone, 3 FPN, 4 FPS, 5 heads/anchors)."""
        c = self.cfg
        point_clouds = inputs["point_clouds"]
        dims_min = inputs["point_cloud_dims_min"]
        dims_max = inputs["point_cloud_dims_max"]
        point_valid = inputs.get("point_validity")
        if point_valid is None:
            point_valid = torch.ones(point_clouds.shape[:2], dtype=torch.bool,
                                     device=point_clouds.device)
        point_cloud_dims = [dims_min, dims_max]

        # ---- voxelize + sparse backbone ----
        caps = c.stage_capacities()
        grid = voxelize(point_clouds[..., :3],
                        self._backbone_feats(point_clouds), point_valid,
                        voxel_size=c.voxel_size, capacity=caps[0],
                        extent=c.grid_extent)
        if debug_stop == 1:
            return {"digest": grid.features.sum() + grid.valid.sum()}
        stages = self.pre_encoder(grid)
        if debug_stop == 2:
            return {"digest": sum(s.features.sum() for s in stages)}

        # ---- FPN top-down ----
        x = stages[-1]
        for i in range(c.num_stages - 1, c.layer_idx - 1, -1):
            if c.use_fpn and i < c.num_stages - 1:
                up = getattr(self, f"up_block_{i + 1}")(x, stages[i])
                x = stages[i].replace(features=stages[i].features
                                      + up.features)
            elif not c.use_fpn:
                x = stages[i]
        out = getattr(self, f"out_block_{c.layer_idx}")(x)
        if debug_stop == 3:
            return {"digest": out.features.sum()}

        # ---- FPS to the seeds ----
        vox_xyz = out.world_xyz() * out.valid[..., None]
        seed_inds = furthest_point_sample(vox_xyz.contiguous(),
                                          c.preenc_npoints)
        enc_xyz = _gather(vox_xyz, seed_inds)
        enc_features = _gather(out.features, seed_inds)
        # with fewer valid voxels than seeds FPS repeats indices; seeds on
        # padded voxel rows are masked out of top-k and attention
        seed_valid = _gather(out.valid, seed_inds)
        if debug_stop == 4:
            return {"digest": enc_features.sum() + enc_xyz.sum()
                    + seed_valid.sum()}

        # ---- projection + seed classification + anchors ----
        enc_features = self.encoder_to_decoder_projection(enc_features)
        point_cls_logits = self.decoder.pointcls_heads(enc_features)
        class_idx = torch.sigmoid(point_cls_logits).argmax(dim=-1)
        if c.hard_anchor:
            size_per_class = torch.ones_like(self.mean_size_arr)
        else:
            size_per_class = self.mean_size_arr
        size_un = size_per_class[class_idx]
        scene = (dims_max - dims_min)[:, None, :]
        query_xyz = enc_xyz
        enc_box_predictions = {
            "point_cls_logits": point_cls_logits,
            "center_unnormalized": query_xyz,
            "center_normalized": (query_xyz - dims_min[:, None, :]) / scene,
            "size_unnormalized": size_un,
            "size_normalized": size_un / scene,
        }
        enc_box_predictions["box_corners"] = box_parametrization_to_corners(
            query_xyz, size_un, torch.zeros_like(query_xyz[..., 0]))
        if debug_stop == 5:
            return {"digest": point_cls_logits.sum()
                    + enc_box_predictions["box_corners"].sum()}

        box_predictions = self.decoder(enc_features, enc_xyz,
                                       point_cloud_dims, enc_box_predictions,
                                       enc_valid=seed_valid)
        box_predictions["seed_inds"] = seed_inds
        box_predictions["seed_xyz"] = enc_xyz
        box_predictions["enc_outputs"] = enc_box_predictions
        return box_predictions


def _unsupported(cfg: VDETRConfig):
    """Config values the JAX model accepts but this slice does not port."""
    out = []
    if cfg.depth not in SparseResNet.ARCH:
        out.append(f"depth={cfg.depth} (Bottleneck)")
    if not cfg.querypos_mlp:
        out.append("querypos_mlp=False (Fourier query embedding)")
    if cfg.pos_for_key:
        out.append("pos_for_key=True")
    if cfg.share_selfattn:
        out.append("share_selfattn=True")
    if cfg.compute_dtype != "float32":
        out.append(f"compute_dtype={cfg.compute_dtype}")
    if cfg.mlp_norm != "bn1d":
        out.append(f"mlp_norm={cfg.mlp_norm}")
    if cfg.mlp_act != "relu":
        out.append(f"mlp_act={cfg.mlp_act}")
    if cfg.random_fps:
        out.append("random_fps=True")
    return out


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random initialisation, every parameter drawn from
    `generator` (the JAX package's scheme where it matters for scale):
    sparse-conv kernels truncated-normal with variance 2 / fan_out;
    dense and 1x1 weights Xavier-uniform; biases 0; norms 1 / 0 with
    running stats 0 / 1; the query embedding N(0, 1); the center/size
    head outputs zero and the focal class-head output bias at the 0.01
    prior."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel":
                fan_out = p.shape[0] * p.shape[2]
                std = math.sqrt(2.0 / fan_out) / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif name.endswith("query_embed.weight"):
                nn.init.normal_(p, 0.0, 1.0, generator=generator)
            elif p.ndim >= 2:
                w = p.reshape(p.shape[0], -1)
                nn.init.xavier_uniform_(w, generator=generator)
                p.copy_(w.reshape(p.shape))
            elif leaf == "weight":  # a norm's scale
                p.fill_(1.0)
            else:
                p.zero_()
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.zero_()
            elif name.endswith("running_var"):
                buf.fill_(1.0)
        for heads in model.decoder.mlp_heads:
            for h in (heads.center_head, heads.size_head):
                h.layers[-1].weight.zero_()
                h.layers[-1].bias.zero_()
            if model.cfg.use_focal:
                heads.sem_cls_head.layers[-1].bias.fill_(FOCAL_PRIOR_BIAS)


def build_model(cfg: VDETRConfig, dataset_config,
                generator: Optional[torch.Generator] = None) -> VDETR:
    """The eval model of `cfg`, initialised from `generator` (default: a
    generator seeded with cfg.seed). Load trained or JAX weights over it
    with `load_state_dict` or `convert.load_jax_params`."""
    cfg.validate()
    missing = _unsupported(cfg)
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))
    model = VDETR(cfg, dataset_config.num_semcls,
                  dataset_config.num_angle_bin,
                  dataset_config.mean_size_arr)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_weights(model, generator)
    return model.eval()
