"""VDETR: the full detector (torch counterpart of
`vdetr_tpu/models/vdetr.py`; reference models/model_vdetr.py). In train
mode its batch norms take batch statistics and its dropout draws from
the generator given to `forward`; gradients reach every parameter, the
sparse convs' through the autograd Function of their route (`conv_route`:
the keyed conv, or the neighbour map and the mapped conv).

Pipeline: voxelize @ 1 cm -> SparseResNet34 -> FPN top-down to stride 4
-> furthest-point-sample 4096 seeds -> seed class head + anchor boxes ->
TransformerDecoder (top-1024 proposals, 8 RPE cross-attention layers).
Every value of the configuration that `VDETRConfig.validate` accepts
builds: Bottleneck depths (50/101/152) widen the FPN by their expansion,
`compute_dtype="bfloat16"` runs the backbone and the FPN in bf16
(`models/backbone.py`), `random_fps` permutes the voxels before FPS in
training, and `querypos_mlp=False` holds the Fourier query embedding's
parameters (`pos_embedding`, `query_projection`), whose output the JAX
model discards.

Key sharding (a config whose mesh has a "seq" axis of S > 1 ranks, the
JAX package's large-scene stress config): each rank of the seq group
(`set_seq_group`) holds a contiguous block of each scene's points and
runs the encoder on it alone, as JAX's shard-local encoder does
(voxelize, backbone, FPN, FPS to `preenc_npoints` seeds of its block,
the heads); the decoder takes every rank's seeds
(`models/transformer.py`). A model of such a config without a seq group
raises rather than run dense.
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
from vdetr_tpu_torch.models.position_embedding import \
    PositionEmbeddingCoordsSine
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
                 mean_size_arr, conv_route: str = "keyed"):
        super().__init__()
        c = cfg
        self.cfg = c
        self.num_semcls = num_semcls
        self.conv_route = conv_route
        caps = c.stage_capacities()
        cd = self.compute_dtype = compute_dtype(c)
        self.pre_encoder = SparseResNet(
            c.backbone_in_dim, depth=c.depth, inplanes=c.inplanes,
            num_stages=c.num_stages, stem_bn=c.stem_bn,
            stage_capacities=caps[1:], conv_route=conv_route,
            compute_dtype=cd)
        expansion = SparseResNet.ARCH[c.depth][0].expansion
        channels = [c.inplanes * 2 ** i * expansion
                    for i in range(c.num_stages)]
        for i in range(c.num_stages - 1, c.layer_idx, -1):
            if c.use_fpn:
                # up_block_{i} lifts stage i to the sites of stage i - 1
                self.add_module(f"up_block_{i}", FPNUpBlock(
                    channels[i], channels[i - 1],
                    woexpand_conv=c.woexpand_conv,
                    generative_capacity=caps[i], conv_route=conv_route,
                    compute_dtype=cd))
        self.add_module(f"out_block_{c.layer_idx}", FPNOutBlock(
            channels[c.layer_idx], c.enc_dim, conv_route=conv_route,
            compute_dtype=cd))
        self.encoder_to_decoder_projection = GenericMLP(
            c.enc_dim, [] if c.proj_nohid else [c.enc_dim], c.dec_dim,
            output_use_activation=True, output_use_norm=True,
            output_use_bias=False)
        if not c.querypos_mlp:
            # held for checkpoint parity; JAX discards their output
            self.pos_embedding = PositionEmbeddingCoordsSine(d_pos=c.dec_dim)
            self.query_projection = GenericMLP(
                c.dec_dim, [c.dec_dim], c.dec_dim, norm=None,
                hidden_use_bias=True, output_use_activation=True)
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

    def forward(self, inputs: Dict[str, torch.Tensor], debug_stop: int = 0,
                generator: Optional[torch.Generator] = None):
        """inputs: point_clouds (B, N, D), point_cloud_dims_min/max (B, 3),
        optional point_validity (B, N) bool. debug_stop k > 0 returns the
        digest the JAX model returns after stage k (1 voxelize, 2
        backbone, 3 FPN, 4 FPS, 5 heads/anchors). `generator` (on the
        model's device) drives dropout in train mode."""
        c = self.cfg
        if self.decoder.seq_group is None and seq_ranks(c) != 1:
            raise ValueError(
                f"the config's mesh {tuple(c.mesh_axis_names)} "
                f"{tuple(c.mesh_shape)} shards the points over a 'seq' axis, "
                "but the model has no seq group: run it under Trainer with "
                "a process group of the mesh's ranks, or call "
                "set_seq_group; a seq config never runs dense")
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
                if self.compute_dtype is None:
                    f = stages[i].features + up.features
                else:  # the skip add in f32, re-stored at the backbone's
                    f = (stages[i].features.float() + up.features.float()
                         ).to(self.compute_dtype)
                x = stages[i].replace(features=f)
            elif not c.use_fpn:
                x = stages[i]
        out = getattr(self, f"out_block_{c.layer_idx}")(x)
        if debug_stop == 3:
            return {"digest": out.features.sum()}

        # ---- FPS to the seeds ----
        vox_xyz = out.world_xyz() * out.valid[..., None]
        vox_feats, vox_valid = out.features, out.valid
        if c.random_fps and self.training and generator is not None:
            # FPS starts at row 0: a random order of the voxels randomizes
            # its start (JAX vdetr.py:136-147, under its dropout rng)
            perm = random_fps_permutation(*vox_valid.shape, generator)
            vox_xyz, vox_feats, vox_valid = (
                _gather(x, perm) for x in (vox_xyz, vox_feats, vox_valid))
        seed_inds = furthest_point_sample(vox_xyz.contiguous(),
                                          c.preenc_npoints)
        enc_xyz = _gather(vox_xyz, seed_inds)
        enc_features = _gather(vox_feats, seed_inds)
        # with fewer valid voxels than seeds FPS repeats indices; seeds on
        # padded voxel rows are masked out of top-k and attention
        seed_valid = _gather(vox_valid, seed_inds)
        if debug_stop == 4:
            return {"digest": enc_features.sum() + enc_xyz.sum()
                    + seed_valid.sum()}

        # ---- projection + seed classification + anchors ----
        enc_features = self.encoder_to_decoder_projection(enc_features)
        point_cls_logits = self.decoder.pointcls_heads(enc_features,
                                                       generator)
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
                                       enc_valid=seed_valid,
                                       generator=generator)
        box_predictions["seed_inds"] = seed_inds
        box_predictions["seed_xyz"] = enc_xyz
        box_predictions["enc_outputs"] = enc_box_predictions
        return box_predictions

    def set_seq_group(self, group) -> None:
        """The seq group whose ranks hold the shards of each scene's
        points (None: the whole scene here)."""
        self.decoder.seq_group = group


def seq_ranks(cfg: VDETRConfig) -> Optional[int]:
    """The size the config's mesh gives its "seq" axis: 1 without one,
    None where it is -1 (the world decides) or the shape does not name
    it."""
    names, shape = tuple(cfg.mesh_axis_names), tuple(cfg.mesh_shape)
    if "seq" not in names:
        return 1
    if len(names) != len(shape) or shape[names.index("seq")] == -1:
        return None
    return shape[names.index("seq")]


def compute_dtype(cfg: VDETRConfig):
    """The backbone's dtype of `cfg.compute_dtype`: None for float32,
    torch.bfloat16 for "bfloat16"."""
    return None if cfg.compute_dtype == "float32" else torch.bfloat16


def random_fps_permutation(B: int, V: int, generator: torch.Generator):
    """The (B, V) voxel order of `random_fps`: a permutation per batch
    row, drawn from `generator` on its device, row 0 first."""
    return torch.stack([torch.randperm(V, generator=generator,
                                       device=generator.device)
                        for _ in range(B)])


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


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when None. Raises when that is a CUDA
    device and CUDA is unavailable: the port never falls back to the CPU
    on its own; callers that want the CPU say so."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def build_model(cfg: VDETRConfig, dataset_config,
                generator: Optional[torch.Generator] = None,
                device=None, conv_route: str = "keyed") -> VDETR:
    """The model of `cfg` in eval mode on `device` (default: the CUDA
    card; raises without one), its weights drawn on the CPU from
    `generator` (default: a generator seeded with cfg.seed). Load trained
    or JAX weights over it with `load_state_dict` or
    `convert.load_jax_params`; both routes take the same weights.

    `conv_route` picks how the sparse 3^3 convs run, the counterpart of
    the JAX package's choice (on the TPU the keyed window kernel; on any
    other backend, or under VDETR_DISABLE_WINDOW_KERNEL, the gather path
    over attached kernel maps): "keyed" (kernel A; the default) or
    "mapped" (kernel G builds each level's neighbour map once, kernel H
    convolves over it, kernel I gives its weight gradient)."""
    device = resolve_device(device)
    cfg.validate()
    model = VDETR(cfg, dataset_config.num_semcls,
                  dataset_config.num_angle_bin,
                  dataset_config.mean_size_arr, conv_route=conv_route)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_weights(model, generator)
    return model.to(device).eval()
