"""V-DETR decoder, eval mode: FFN proposal layer, top-k query selection
and the global decoder layers with vertex-RPE cross-attention (torch
counterpart of `vdetr_tpu/models/transformer.py`; reference
models/vdetr_transformer.py).

Layouts are channel-last (B, N, C). Dropout modules are kept where the
reference has them, for its state_dict names, and are the identity in
eval. Parameter names follow the reference V-DETR state_dict.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vdetr_tpu_torch.geometry.boxes import (
    box_parametrization_to_corners,
    convert_corners_camera2lidar,
)
from vdetr_tpu_torch.models.mlp import GenericMLP, PositionEmbeddingLearned
from vdetr_tpu_torch.ops.rpe import make_coords_table
from vdetr_tpu_torch.ops.rpe_attention import rpe_cross_attention

FOCAL_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)
# flax.linen.LayerNorm's default epsilon, which the JAX package uses
LN_EPS = 1e-6


# --------------------------------------------------------------------------
# Box processing (reference vdetr_transformer.py:20-90)
# --------------------------------------------------------------------------

def compute_predicted_angle(angle_logits, angle_residual, num_angle_bin,
                            zero_angle=False):
    if angle_logits.shape[-1] == 1 or zero_angle:
        if angle_logits.shape[-1] == 1:
            angle = (angle_logits * 0 + angle_residual * 0).squeeze(-1)
        else:
            angle = angle_logits.sum(-1) * 0 + angle_residual.sum(-1) * 0
        angle = angle.clamp(min=0.0)
        return angle, angle
    per_cls = 2 * np.pi / num_angle_bin
    prob = torch.softmax(angle_logits, dim=-1)
    angle_prob = prob.max(dim=-1).values
    cls = prob.argmax(dim=-1)  # first index on ties, as jnp.argmax
    res = angle_residual.gather(-1, cls[..., None])[..., 0]
    angle = per_cls * cls + res
    angle = torch.where(angle > np.pi, angle - 2 * np.pi, angle)
    return angle, angle_prob


def objectness_and_cls_prob(cls_logits, use_focal: bool):
    if use_focal:
        return cls_logits, torch.sigmoid(cls_logits).max(dim=-1).values
    prob = torch.softmax(cls_logits, dim=-1)
    return prob[..., :-1], 1.0 - prob[..., -1]


def refine_box_predictions(heads_out, pre_center_normalized,
                           pre_size_normalized, point_cloud_dims,
                           num_angle_bin, use_focal):
    """Head outputs -> box predictions relative to the priors (reference
    vdetr_transformer.py:244-333)."""
    cls_logits = heads_out["sem_cls"]
    center_reg = heads_out["center"]
    size_reg = heads_out["size"]
    angle_logits = heads_out["angle_cls"]
    angle_residual_normalized = heads_out["angle_residual"]

    dims_min, dims_max = point_cloud_dims
    scene = (dims_max - dims_min)[:, None, :]
    pre_center_un = pre_center_normalized * scene + dims_min[:, None, :]
    pre_size_un = pre_size_normalized * scene

    center_un = center_reg * pre_size_un + pre_center_un
    center_norm = (center_un - dims_min[:, None, :]) / scene
    size_un = torch.exp(size_reg) * pre_size_un
    size_norm = size_un / scene

    angle_residual = angle_residual_normalized * (
        np.pi / angle_residual_normalized.shape[-1])
    angle, angle_prob = compute_predicted_angle(angle_logits, angle_residual,
                                                num_angle_bin)
    corners = box_parametrization_to_corners(center_un, size_un, angle)
    angle_zero, _ = compute_predicted_angle(angle_logits, angle_residual,
                                            num_angle_bin, zero_angle=True)
    corners_aa = box_parametrization_to_corners(center_un, size_un,
                                                angle_zero)
    semcls_prob, obj_prob = objectness_and_cls_prob(cls_logits, use_focal)
    return {
        "sem_cls_logits": cls_logits,
        "center_normalized": center_norm,
        "center_unnormalized": center_un,
        "size_normalized": size_norm,
        "size_unnormalized": size_un,
        "angle_logits": angle_logits,
        "angle_prob": angle_prob,
        "angle_residual": angle_residual,
        "angle_residual_normalized": angle_residual_normalized,
        "angle_continuous": angle,
        "objectness_prob": obj_prob,
        "sem_cls_prob": semcls_prob,
        "box_corners": corners,
        "box_corners_axis_align": corners_aa,
        "pre_box_center_unnormalized": pre_center_un,
        "center_reg": center_reg,
        "pre_box_size_unnormalized": pre_size_un,
        "size_reg": size_reg,
    }


# --------------------------------------------------------------------------
# Attention modules
# --------------------------------------------------------------------------

class MultiHeadSelfAttention(nn.Module):
    """nn.MultiheadAttention's function and parameter names (packed
    in_proj, out_proj), written out with plain matmuls and softmax."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q_in, k_in, v_in):
        B, N, D = q_in.shape
        H = self.num_heads
        hd = D // H
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(q_in, wq, bq).reshape(B, N, H, hd) * (hd ** -0.5)
        k = F.linear(k_in, wk, bk).reshape(B, N, H, hd)
        v = F.linear(v_in, wv, bv).reshape(B, N, H, hd)
        attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, N, D)
        return self.out_proj(out)


class GlobalShareCrossAttention(nn.Module):
    """Cross-attention with the 8-corner RPE bias and one shared K/V head
    (reference vdetr_transformer.py:656-758). The attention itself is the
    Hopper kernel (`ops/rpe_attention.py`)."""

    def __init__(self, dim: int, num_heads: int, rpe_dim: int,
                 rpe_quant: str = "bilinear_4_10", log_scale: float = 512.0,
                 angle_type: str = ""):
        super().__init__()
        _, max_value, num_points = rpe_quant.split("_")
        self.max_value = float(max_value)
        self.num_points = int(num_points)
        self.num_heads = num_heads
        self.log_scale = log_scale
        self.rotate = angle_type == "object_coords"
        hd = dim // num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, hd)
        self.v = nn.Linear(dim, hd)
        self.proj = nn.Linear(dim, dim)
        self.cpb_mlps = nn.ModuleList([
            nn.Sequential(nn.Linear(3, rpe_dim), nn.ReLU(),
                          nn.Linear(rpe_dim, num_heads, bias=False))
            for _ in range(8)])
        self.register_buffer(
            "coords_table",
            torch.from_numpy(make_coords_table(self.max_value,
                                               self.num_points)),
            persistent=False)

    def rpe_tables(self):
        """The 8 corner tables, (8, n, n, n, H)."""
        n = self.num_points
        return torch.stack([
            mlp(self.coords_table).reshape(n, n, n, self.num_heads)
            for mlp in self.cpb_mlps])

    def forward(self, query, key, reference_point, reference_angle, key_xyz,
                key_valid=None):
        B, nQ, D = query.shape
        H = self.num_heads
        hd = D // H
        q = self.q(query).reshape(B, nQ, H, hd) * (hd ** -0.5)
        out = rpe_cross_attention(
            q.contiguous(), self.k(key).contiguous(),
            self.v(key).contiguous(), reference_point.contiguous(),
            reference_angle.contiguous(), key_xyz.contiguous(),
            self.rpe_tables().contiguous(), key_valid,
            log_scale=self.log_scale, max_value=self.max_value,
            rotate=self.rotate)
        return self.proj(out.reshape(B, nQ, D))


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

class FFNLayer(nn.Module):
    """Pre-norm FFN over the seed tokens, decoder "layer 0" (reference
    vdetr_transformer.py:585-606)."""

    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)

    def forward(self, memory):
        m = self.norm(memory)
        return m + self.linear2(F.relu(self.linear1(m)))


class GlobalDecoderLayer(nn.Module):
    """Pre-norm: self-attn -> RPE cross-attn -> FFN (reference
    vdetr_transformer.py:455-582, forward_pre)."""

    def __init__(self, cfg):
        super().__init__()
        c = cfg
        self.norm1 = nn.LayerNorm(c.dec_dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(c.dec_dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(c.dec_dim, eps=LN_EPS)
        self.self_attn = MultiHeadSelfAttention(c.dec_dim, c.dec_nhead)
        self.multihead_attn = GlobalShareCrossAttention(
            c.dec_dim, c.dec_nhead, c.rpe_dim, c.rpe_quant, c.log_scale,
            c.angle_type)
        self.linear1 = nn.Linear(c.dec_dim, c.dec_ffn_dim)
        self.linear2 = nn.Linear(c.dec_ffn_dim, c.dec_dim)

    def forward(self, tgt, memory, reference_point, reference_angle,
                enc_xyz, query_pos, key_valid=None):
        t2 = self.norm1(tgt)
        q = t2 + query_pos
        tgt = tgt + self.self_attn(q, q, t2)
        t2 = self.norm2(tgt)
        tgt = tgt + self.multihead_attn(t2 + query_pos, memory,
                                        reference_point, reference_angle,
                                        enc_xyz, key_valid)
        t2 = self.norm3(tgt)
        return tgt + self.linear2(F.relu(self.linear1(t2)))


_HEADS = ("sem_cls", "center", "size", "angle_cls", "angle_residual")


class BoxHeads(nn.Module):
    """One per-layer set of MLP heads (reference
    vdetr_transformer.py:194-234)."""

    def __init__(self, cfg, num_semcls: int, num_angle_bin: int):
        super().__init__()
        c = cfg
        outs = dict(sem_cls=num_semcls, center=3, size=3,
                    angle_cls=num_angle_bin, angle_residual=num_angle_bin)
        for h in _HEADS:
            self.add_module(f"{h}_head", GenericMLP(
                c.dec_dim, [c.dec_dim, c.dec_dim], outs[h],
                dropout=c.mlp_dropout))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        return {h: getattr(self, f"{h}_head")(x) for h in _HEADS}


class PointClsHead(GenericMLP):
    """Per-seed classification head (reference
    vdetr_transformer.py:176-192)."""

    def __init__(self, cfg, num_semcls: int):
        c = cfg
        out = num_semcls if c.use_focal else num_semcls + 1
        super().__init__(c.dec_dim, [c.dec_dim, c.dec_dim], out,
                         dropout=c.mlp_dropout)


class TransformerDecoder(nn.Module):
    """Reference vdetr_transformer.py:105-452, eval only."""

    def __init__(self, cfg, num_semcls: int, num_angle_bin: int):
        super().__init__()
        c = cfg
        if c.q_content not in ("zero", "random", "random_add", "sample"):
            raise ValueError(f"unknown q_content {c.q_content!r}")
        self.cfg = c
        self.num_semcls = num_semcls
        self.num_angle_bin = num_angle_bin
        num_layers = c.dec_nlayers - 1  # the first FFN layer counts as one
        self.first_layer = FFNLayer(c.dec_dim, c.dec_ffn_dim)
        self.norm = nn.LayerNorm(c.dec_dim, eps=LN_EPS)  # shared by layers
        if c.q_content in ("random", "random_add"):
            self.query_embed = nn.Embedding(c.nqueries, c.dec_dim)
        self.query_pos_projection = nn.ModuleList([
            PositionEmbeddingLearned(6, c.dec_dim) for _ in range(num_layers)])
        self.layers = nn.ModuleList([GlobalDecoderLayer(c)
                                     for _ in range(num_layers)])
        first_cls = 1 if c.is_bilable else num_semcls
        self.mlp_heads = nn.ModuleList(
            [BoxHeads(c, first_cls, num_angle_bin)]
            + [BoxHeads(c, num_semcls, num_angle_bin)
               for _ in range(num_layers)])
        self.pointcls_heads = PointClsHead(c, num_semcls)

    def forward(self, enc_features, enc_xyz, point_cloud_dims,
                enc_box_predictions, enc_valid=None):
        c = self.cfg
        output = self.first_layer(enc_features)
        pred0 = refine_box_predictions(
            self.mlp_heads[0](self.norm(output)),
            enc_box_predictions["center_normalized"],
            enc_box_predictions["size_normalized"],
            point_cloud_dims, self.num_angle_bin, c.use_focal)
        intermediate: List[Dict[str, torch.Tensor]] = [pred0]

        # top-k proposals; a stable descending sort keeps lax.top_k's
        # lower-index-first order among equal scores
        obj = pred0["objectness_prob"]
        if enc_valid is not None:
            obj = torch.where(enc_valid, obj, -torch.inf)
        nq = min(c.nqueries, obj.shape[1])
        topk = torch.sort(obj, dim=1, descending=True,
                          stable=True).indices[:, :nq]

        def g(x):
            idx = topk.reshape(topk.shape + (1,) * (x.ndim - 2))
            return x.gather(1, idx.expand((-1, -1) + x.shape[2:]))

        reference_point = convert_corners_camera2lidar(
            g(pred0["box_corners"]))
        reference_center = g(pred0["center_unnormalized"])
        reference_size = g(pred0["size_unnormalized"])
        reference_angle = g(pred0["angle_continuous"])
        proposal_center_norm = g(pred0["center_normalized"])
        proposal_size_norm = g(pred0["size_normalized"])
        output = g(output)
        if c.q_content == "zero":
            output = torch.zeros_like(output)
        elif c.q_content in ("random", "random_add"):
            qe = self.query_embed.weight[None, :nq].expand(
                output.shape[0], -1, -1)
            output = qe if c.q_content == "random" else output + qe

        box_prediction = pred0
        for idx, layer in enumerate(self.layers):
            if idx > 0:
                reference_point = convert_corners_camera2lidar(
                    box_prediction["box_corners"])
                reference_center = box_prediction["center_unnormalized"]
                reference_size = box_prediction["size_unnormalized"]
                reference_angle = box_prediction["angle_continuous"]
            query_pos = self.query_pos_projection[idx](
                torch.cat([reference_center, reference_size], dim=-1))
            output = layer(output, enc_features, reference_point,
                           reference_angle, enc_xyz, query_pos, enc_valid)
            box_prediction = refine_box_predictions(
                self.mlp_heads[idx + 1](self.norm(output)),
                proposal_center_norm, proposal_size_norm, point_cloud_dims,
                self.num_angle_bin, c.use_focal)
            intermediate.append(box_prediction)

        return {"outputs": intermediate[-1],
                "aux_outputs": intermediate[:-1]}
