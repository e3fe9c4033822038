"""V-DETR decoder: FFN proposal layer, top-k query selection and the
global decoder layers with vertex-RPE cross-attention (torch counterpart
of `vdetr_tpu/models/transformer.py`; reference
models/vdetr_transformer.py).

Layouts are channel-last (B, N, C). Parameter names follow the reference
V-DETR state_dict. In train mode dropout acts at every site where the
JAX modules have `nn.Dropout(..., deterministic=not train)`, drawing
from the `generator` passed down the forward, and the boxes that prime
each layer are detached where the JAX package stops gradients.

Key sharding (the JAX package's "seq" mesh axis, `cfg.seq_axis`): with a
seq group set (`TransformerDecoder.seq_group`), the seeds are this rank's
shard. The layer-0 predictions are all-gathered so that aux0 and the
top-k proposals see every seed, the chosen query features are gathered
from the rank that owns each (`parallel/seq_attention.py`), and every
cross-attention runs kernel C on the local keys with the shards merged by
their log-sum-exps (`ops/rpe_attention.py:sharded_rpe_cross_attention`;
the JAX package materializes each shard's bias there instead). The query
path is then the same on every rank of the group.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vdetr_tpu_torch.geometry.boxes import (
    box_parametrization_to_corners,
    convert_corners_camera2lidar,
)
from vdetr_tpu_torch.models.mlp import (LN_EPS, Dropout, GenericMLP,
                                        PositionEmbeddingLearned)
from vdetr_tpu_torch.ops.rpe import make_coords_table
from vdetr_tpu_torch.ops.rpe_attention import (rpe_cross_attention,
                                               rpe_cross_attention_ad,
                                               sharded_rpe_cross_attention)
from vdetr_tpu_torch.parallel import dist
from vdetr_tpu_torch.parallel.seq_attention import gather_selected_sharded

FOCAL_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


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
    semcls_prob, obj_prob = objectness_and_cls_prob(cls_logits.detach(),
                                                    use_focal)
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

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        self.attn_drop = Dropout(dropout)

    def forward(self, q_in, k_in, v_in, generator=None):
        B, N, D = q_in.shape
        H = self.num_heads
        hd = D // H
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(q_in, wq, bq).reshape(B, N, H, hd) * (hd ** -0.5)
        k = F.linear(k_in, wk, bk).reshape(B, N, H, hd)
        v = F.linear(v_in, wv, bv).reshape(B, N, H, hd)
        attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        attn = self.attn_drop(attn, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, N, D)
        return self.out_proj(out)


class ShareSelfAttention(nn.Module):
    """Self-attention with one K/V head of width dim / heads shared by
    the query heads (reference vdetr_transformer.py:609-653, JAX
    `ShareSelfAttention`; `share_selfattn=True`). Dropout acts on the
    attention weights and again after `proj`."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, hd)
        self.v = nn.Linear(dim, hd)
        self.proj = nn.Linear(dim, dim)
        self.attn_drop = Dropout(dropout)
        self.proj_drop = Dropout(dropout)

    def forward(self, q_in, k_in, v_in, generator=None):
        B, N, D = q_in.shape
        H = self.num_heads
        hd = D // H
        q = self.q(q_in).reshape(B, N, H, hd) * (hd ** -0.5)
        attn = torch.softmax(torch.einsum("bqhd,bkd->bhqk", q,
                                          self.k(k_in)), dim=-1)
        attn = self.attn_drop(attn, generator)
        out = torch.einsum("bhqk,bkd->bqhd", attn,
                           self.v(v_in)).reshape(B, N, D)
        return self.proj_drop(self.proj(out), generator)


class GlobalShareCrossAttention(nn.Module):
    """Cross-attention with the 8-corner RPE bias and one shared K/V head
    (reference vdetr_transformer.py:656-758). The attention itself is the
    Hopper kernel (`ops/rpe_attention.py`), its backward the flash
    backward kernel; in train mode it drops attention weights in-kernel,
    seeded from the generator."""

    def __init__(self, dim: int, num_heads: int, rpe_dim: int,
                 rpe_quant: str = "bilinear_4_10", log_scale: float = 512.0,
                 angle_type: str = "", dropout: float = 0.0):
        super().__init__()
        self.dropout = float(dropout)
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
        self.proj_drop = Dropout(dropout)
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
                key_valid=None, generator=None, seq_group=None,
                key_offset: int = 0):
        """`seq_group`: the keys are this rank's shard of the group's,
        the first at global index `key_offset`."""
        B, nQ, D = query.shape
        H = self.num_heads
        hd = D // H
        q = self.q(query).reshape(B, nQ, H, hd) * (hd ** -0.5)
        rate = self.dropout if self.training else 0.0
        seed = None
        if rate > 0:
            if generator is None:
                raise ValueError("dropout in train mode needs a "
                                 "torch.Generator")
            seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=generator.device)
        kw = dict(log_scale=self.log_scale, max_value=self.max_value,
                  rotate=self.rotate, dropout_rate=rate, seed=seed)
        if seq_group is not None:
            attend = sharded_rpe_cross_attention
            kw.update(group=seq_group, key_offset=key_offset)
        elif torch.is_grad_enabled():
            attend = rpe_cross_attention_ad
        else:
            attend = rpe_cross_attention
        out = attend(
            q.contiguous(), self.k(key).contiguous(),
            self.v(key).contiguous(), reference_point.contiguous(),
            reference_angle.contiguous(), key_xyz.contiguous(),
            self.rpe_tables().contiguous(), key_valid, **kw)
        return self.proj_drop(self.proj(out.reshape(B, nQ, D)), generator)


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

class FFNLayer(nn.Module):
    """Pre-norm FFN over the seed tokens, decoder "layer 0" (reference
    vdetr_transformer.py:585-606)."""

    def __init__(self, dim: int, ffn_dim: int, dropout: float = 0.0):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)

    def forward(self, memory, generator=None):
        m = self.norm(memory)
        h = self.dropout1(F.relu(self.linear1(m)), generator)
        return m + self.dropout2(self.linear2(h), generator)


class GlobalDecoderLayer(nn.Module):
    """Pre-norm: self-attn -> RPE cross-attn -> FFN (reference
    vdetr_transformer.py:455-582, forward_pre)."""

    def __init__(self, cfg):
        super().__init__()
        c = cfg
        self.norm1 = nn.LayerNorm(c.dec_dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(c.dec_dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(c.dec_dim, eps=LN_EPS)
        attn = ShareSelfAttention if c.share_selfattn \
            else MultiHeadSelfAttention
        self.self_attn = attn(c.dec_dim, c.dec_nhead, c.dec_dropout)
        self.multihead_attn = GlobalShareCrossAttention(
            c.dec_dim, c.dec_nhead, c.rpe_dim, c.rpe_quant, c.log_scale,
            c.angle_type, c.dec_dropout)
        self.linear1 = nn.Linear(c.dec_dim, c.dec_ffn_dim)
        self.linear2 = nn.Linear(c.dec_ffn_dim, c.dec_dim)
        # after self-attention, cross-attention, the FFN's relu and its
        # output (JAX transformer.py:416, 429, 434, 436)
        self.dropout1, self.dropout2, self.dropout3, self.dropout4 = (
            Dropout(c.dec_dropout) for _ in range(4))

    def forward(self, tgt, memory, reference_point, reference_angle,
                enc_xyz, query_pos, key_valid=None, key_pos=None,
                generator=None, seq_group=None, key_offset: int = 0):
        """`key_pos` (pos_for_key) is added to the cross-attention's key
        input, from which it projects K and V (JAX transformer.py:419-421)."""
        t2 = self.norm1(tgt)
        q = t2 + query_pos
        tgt = tgt + self.dropout1(self.self_attn(q, q, t2, generator),
                                  generator)
        t2 = self.norm2(tgt)
        key = memory if key_pos is None else memory + key_pos
        ca = self.multihead_attn(t2 + query_pos, key, reference_point,
                                 reference_angle, enc_xyz, key_valid,
                                 generator, seq_group, key_offset)
        tgt = tgt + self.dropout2(ca, generator)
        t2 = self.norm3(tgt)
        h = self.dropout3(F.relu(self.linear1(t2)), generator)
        return tgt + self.dropout4(self.linear2(h), generator)


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
                dropout=c.mlp_dropout, norm=c.mlp_norm,
                activation=c.mlp_act))

    def forward(self, x, generator=None) -> Dict[str, torch.Tensor]:
        return {h: getattr(self, f"{h}_head")(x, generator) for h in _HEADS}


class PointClsHead(GenericMLP):
    """Per-seed classification head (reference
    vdetr_transformer.py:176-192)."""

    def __init__(self, cfg, num_semcls: int):
        c = cfg
        out = num_semcls if c.use_focal else num_semcls + 1
        super().__init__(c.dec_dim, [c.dec_dim, c.dec_dim], out,
                         dropout=c.mlp_dropout, norm=c.mlp_norm,
                         activation=c.mlp_act)


def select_proposals(obj, nq: int):
    """(B, nq) indices of the nq largest scores of obj (B, K), largest
    first: `lax.top_k`'s choice (JAX transformer.py:523), the lower index
    first among equal scores, which a stable descending sort keeps."""
    return torch.sort(obj, dim=1, descending=True, stable=True).indices[:, :nq]


class TransformerDecoder(nn.Module):
    """Reference vdetr_transformer.py:105-452."""

    def __init__(self, cfg, num_semcls: int, num_angle_bin: int):
        super().__init__()
        c = cfg
        if c.q_content not in ("zero", "random", "random_add", "sample"):
            raise ValueError(f"unknown q_content {c.q_content!r}")
        self.cfg = c
        self.num_semcls = num_semcls
        self.num_angle_bin = num_angle_bin
        num_layers = c.dec_nlayers - 1  # the first FFN layer counts as one
        self.first_layer = FFNLayer(c.dec_dim, c.dec_ffn_dim, c.dec_dropout)
        self.norm = nn.LayerNorm(c.dec_dim, eps=LN_EPS)  # shared by layers
        if c.q_content in ("random", "random_add"):
            self.query_embed = nn.Embedding(c.nqueries, c.dec_dim)
        self.query_pos_projection = nn.ModuleList([
            PositionEmbeddingLearned(6, c.dec_dim) for _ in range(num_layers)])
        if c.pos_for_key:  # a learned key embedding of enc_xyz per layer
            self.key_pos_projection = nn.ModuleList([
                PositionEmbeddingLearned(3, c.dec_dim)
                for _ in range(num_layers)])
        self.layers = nn.ModuleList([GlobalDecoderLayer(c)
                                     for _ in range(num_layers)])
        first_cls = 1 if c.is_bilable else num_semcls
        self.mlp_heads = nn.ModuleList(
            [BoxHeads(c, first_cls, num_angle_bin)]
            + [BoxHeads(c, num_semcls, num_angle_bin)
               for _ in range(num_layers)])
        self.pointcls_heads = PointClsHead(c, num_semcls)
        # the seq group whose ranks hold the seeds' shards (None: dense)
        self.seq_group = None

    def forward(self, enc_features, enc_xyz, point_cloud_dims,
                enc_box_predictions, enc_valid=None,
                generator: Optional[torch.Generator] = None):
        c = self.cfg
        seq = self.seq_group
        output = self.first_layer(enc_features, generator)
        pred0 = refine_box_predictions(
            self.mlp_heads[0](self.norm(output), generator),
            enc_box_predictions["center_normalized"],
            enc_box_predictions["size_normalized"],
            point_cloud_dims, self.num_angle_bin, c.use_focal)
        enc_valid_glob, shard_off = enc_valid, 0
        if seq is not None:
            # the seeds are sharded: the layer-0 predictions of every seed
            # (small), so that aux0 and the top-k are the dense ones
            # (JAX transformer.py:498-517)
            shard_off = dist.rank(seq) * output.shape[1]
            pred0 = _gather_seeds(pred0, seq)
            if enc_valid is not None:
                enc_valid_glob = dist.all_gather_dim(enc_valid, 1, seq)
        intermediate: List[Dict[str, torch.Tensor]] = [pred0]

        # top-k proposals (the objectness is detached in
        # refine_box_predictions)
        obj = pred0["objectness_prob"]
        if enc_valid is not None:
            obj = torch.where(enc_valid_glob, obj, -torch.inf)
        nq = min(c.nqueries, obj.shape[1])
        topk = select_proposals(obj, nq)

        def g(x):
            idx = topk.reshape(topk.shape + (1,) * (x.ndim - 2))
            return x.gather(1, idx.expand((-1, -1) + x.shape[2:]))

        # the layers refine detached priors (JAX transformer.py:530-538)
        sg = {k: pred0[k].detach() for k in (
            "box_corners", "center_unnormalized", "size_unnormalized",
            "angle_continuous", "center_normalized", "size_normalized")}
        reference_point = convert_corners_camera2lidar(g(sg["box_corners"]))
        reference_center = g(sg["center_unnormalized"])
        reference_size = g(sg["size_unnormalized"])
        reference_angle = g(sg["angle_continuous"])
        proposal_center_norm = g(sg["center_normalized"])
        proposal_size_norm = g(sg["size_normalized"])
        output = (g(output) if seq is None else
                  gather_selected_sharded(output, topk, shard_off, seq))
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
                    box_prediction["box_corners"].detach())
                reference_center = \
                    box_prediction["center_unnormalized"].detach()
                reference_size = box_prediction["size_unnormalized"].detach()
                reference_angle = box_prediction["angle_continuous"].detach()
            query_pos = self.query_pos_projection[idx](
                torch.cat([reference_center, reference_size], dim=-1))
            key_pos = (self.key_pos_projection[idx](enc_xyz)
                       if c.pos_for_key else None)
            output = layer(output, enc_features, reference_point,
                           reference_angle, enc_xyz, query_pos, enc_valid,
                           key_pos, generator, seq, shard_off)
            box_prediction = refine_box_predictions(
                self.mlp_heads[idx + 1](self.norm(output), generator),
                proposal_center_norm, proposal_size_norm, point_cloud_dims,
                self.num_angle_bin, c.use_focal)
            intermediate.append(box_prediction)

        return {"outputs": intermediate[-1],
                "aux_outputs": intermediate[:-1]}


def _gather_seeds(pred: Dict[str, torch.Tensor], group
                  ) -> Dict[str, torch.Tensor]:
    """Each (B, n_loc, ...) entry of `pred` all-gathered along the seeds
    over `group`, in rank order (one all-gather of them packed;
    differentiable)."""
    keys = list(pred)
    B, n = pred[keys[0]].shape[:2]
    flat = [pred[k].reshape(B, n, -1).float() for k in keys]
    widths = [f.shape[2] for f in flat]
    full = dist.all_gather_dim(torch.cat(flat, dim=2), 1, group)
    out = {}
    for k, part in zip(keys, full.split(widths, dim=2)):
        out[k] = part.reshape((B, full.shape[1]) + pred[k].shape[2:]).to(
            pred[k].dtype)
    return out
