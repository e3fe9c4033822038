"""Boxes, the vertex-RPE cross-attention and the V-DETR decoder, plain
(frozen copy of `vdetr_tpu_torch/geometry/boxes.py`, `ops/rpe.py`, the
plain versions of `ops/rpe_attention.py` and `models/transformer.py`,
dense keys, float32).

The attention materializes the (B, H, nQ, nK) logits with the 8 corner
biases, each a trilinear sample of its table at the log-quantized
corner-to-key delta; training drops attention weights after the softmax
by the counter hash of (seed, batch, head, query, key), and its gradient
is the plain flash backward, which works the biases' taps out again
rather than saving them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.nets import (LN_EPS, Dropout, GenericMLP,
                                      PositionEmbeddingLearned)

FOCAL_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)
NEG_INF = -1e9
_U32 = 0xFFFFFFFF

# --------------------------------------------------------------------------
# boxes
# --------------------------------------------------------------------------

_SX = (1, 1, -1, -1, 1, 1, -1, -1)
_SY = (1, 1, 1, 1, -1, -1, -1, -1)
_SZ = (1, -1, -1, 1, 1, -1, -1, 1)


def flip_axis_to_camera(pc):
    return torch.stack([pc[..., 0], -pc[..., 2], pc[..., 1]], dim=-1)


def convert_corners_camera2lidar(corners):
    return torch.stack([corners[..., 0], corners[..., 2], -corners[..., 1]],
                       dim=-1)


def roty_batch(t):
    c, s = torch.cos(t), torch.sin(t)
    z, o = torch.zeros_like(t), torch.ones_like(t)
    return torch.stack([torch.stack([c, z, s], dim=-1),
                        torch.stack([z, o, z], dim=-1),
                        torch.stack([-s, z, c], dim=-1)], dim=-2)


def get_3d_box_batch(box_size, angle, center):
    l = box_size[..., 0:1] * 0.5
    w = box_size[..., 1:2] * 0.5
    h = box_size[..., 2:3] * 0.5
    kw = dict(dtype=box_size.dtype, device=box_size.device)
    corners = torch.stack([l * torch.tensor(_SX, **kw),
                           h * torch.tensor(_SY, **kw),
                           w * torch.tensor(_SZ, **kw)], dim=-1)
    R = roty_batch(angle)
    corners = (corners[..., None, :] * R[..., None, :, :]).sum(-1)
    return corners + center[..., None, :]


def box_parametrization_to_corners(center_unnorm, box_size, box_angle):
    return get_3d_box_batch(box_size, box_angle,
                            flip_axis_to_camera(center_unnorm))


# --------------------------------------------------------------------------
# RPE tables and the attention
# --------------------------------------------------------------------------

def log_quantize(delta, log_scale: float, max_value: float):
    q = torch.sign(delta) * torch.log2(torch.abs(delta) * log_scale + 1.0)
    return q / float(np.log2(8.0)) / max_value


def make_coords_table(max_value: float, num_points: int) -> np.ndarray:
    lin = np.linspace(-max_value, max_value, num_points, dtype=np.float32)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1)
    return g.reshape(-1, 3)


def trilinear_taps(p0, p1, p2, n: int):
    """The 8 (flat cell, weight) taps of samples in [-1, 1] on an n^3 grid
    (align_corners=False, zero padding; component 0 the last axis)."""
    def to_idx(p):
        return ((p + 1.0) * n - 1.0) * 0.5

    iw, ih, id_ = torch.broadcast_tensors(to_idx(p0), to_idx(p1),
                                          to_idx(p2))
    fw, fh, fd = torch.floor(iw), torch.floor(ih), torch.floor(id_)
    ww, wh, wd = iw - fw, ih - fh, id_ - fd
    fw, fh, fd = fw.long(), fh.long(), fd.long()
    taps = []
    for dw in (0, 1):
        for dh in (0, 1):
            for dd in (0, 1):
                cw, ch, cd = fw + dw, fh + dh, fd + dd
                inb = ((cw >= 0) & (cw < n) & (ch >= 0) & (ch < n)
                       & (cd >= 0) & (cd < n))
                w = ((ww if dw else 1.0 - ww) * (wh if dh else 1.0 - wh)
                     * (wd if dd else 1.0 - wd)) * inb
                cell = ((cd.clamp(0, n - 1) * n + ch.clamp(0, n - 1)) * n
                        + cw.clamp(0, n - 1))
                taps.append((cell, w))
    return taps


def trilinear_sample(table, p0, p1, p2):
    """(H, ...) samples of table (n, n, n, H)."""
    n, H = table.shape[0], table.shape[-1]
    flat = table.reshape(-1, H).t().contiguous()
    out = None
    for cell, w in trilinear_taps(p0, p1, p2, n):
        term = flat[:, cell] * w
        out = term if out is None else out + term
    return out


def _mul32(x, c: int):
    return (x * (c & 0xFFFF) + ((x * (c >> 16)) & 0xFFFF) * 65536) & _U32


def _hash32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_keep(seed, B: int, H: int, nQ: int, nK: int, rate: float):
    """(B, H, nQ, nK) keep mask of attention dropout: x = hash(hash(seed ^
    hash(row)) ^ key * 0x9E3779B1), kept iff x >> 8 >= floor(rate 2^24)."""
    dev = seed.device
    row = torch.arange(B * H * nQ, dtype=torch.int64, device=dev)
    rowh = _hash32((seed.reshape(()) & _U32) ^ _hash32(row))
    key = _mul32(torch.arange(nK, dtype=torch.int64, device=dev) & _U32,
                 0x9E3779B1)
    x = _hash32(rowh[:, None] ^ key[None, :])
    return ((x >> 8) >= int(rate * (1 << 24))).reshape(B, H, nQ, nK)


def _deltas(corners, angles, key_xyz, c: int, rotate: bool):
    corner = corners[:, :, c, :]
    dx = corner[:, :, 0:1] - key_xyz[:, None, :, 0]
    dy = corner[:, :, 1:2] - key_xyz[:, None, :, 1]
    dz = corner[:, :, 2:3] - key_xyz[:, None, :, 2]
    if rotate:
        co = torch.cos(angles)[..., None]
        si = torch.sin(angles)[..., None]
        dx, dy = dx * co - dy * si, dx * si + dy * co
    return dx, dy, dz


def rpe_attention(q, k, v, corners, angles, key_xyz, tables, key_valid, *,
                  log_scale, max_value, rotate=False, dropout_rate=0.0,
                  seed=None, return_stats=False):
    """out (B, nQ, H, hd); with return_stats also the row log-sum-exp (B,
    nQ, H) and the masked logits (B, H, nQ, nK)."""
    B, nQ, H, _ = q.shape
    nK = k.shape[1]
    attn = torch.einsum("bqhd,bkd->bhqk", q, k)
    for c in range(8):
        dx, dy, dz = _deltas(corners, angles, key_xyz, c, rotate)
        bias = trilinear_sample(tables[c],
                                log_quantize(dx, log_scale, max_value),
                                log_quantize(dy, log_scale, max_value),
                                log_quantize(dz, log_scale, max_value))
        attn = attn + bias.transpose(0, 1)
        del dx, dy, dz, bias
    if key_valid is not None:
        attn = torch.where(key_valid[:, None, None, :], attn, NEG_INF)
    p = torch.softmax(attn, dim=-1)
    if dropout_rate > 0:
        p = torch.where(dropout_keep(seed, B, H, nQ, nK, dropout_rate),
                        p * (1.0 / (1.0 - dropout_rate)), 0.0)
    out = torch.einsum("bhqk,bkd->bqhd", p, v)
    if not return_stats:
        return out
    lse = torch.logsumexp(attn, dim=-1).permute(0, 2, 1)
    if key_valid is not None:
        lse = torch.where(key_valid.any(dim=1)[:, None, None], lse, 0.0)
    return out, lse.contiguous(), attn


def rpe_attention_bwd(k, v, corners, angles, key_xyz, key_valid, out, dout,
                      logits, lse, n: int, *, log_scale, max_value,
                      rotate=False, dropout_rate=0.0, seed=None):
    """(dq, dtables, ds, eg) of the attention's flash backward."""
    B, nQ, H, _ = dout.shape
    nK = k.shape[1]
    lse_h = lse.permute(0, 2, 1)[..., None]
    if key_valid is None:
        key_valid = torch.ones(B, nK, dtype=torch.bool, device=k.device)
    valid = key_valid[:, None, None, :]
    any_valid = key_valid.any(dim=1)[:, None, None, None]
    e = torch.where(valid, torch.exp(logits - lse_h),
                    torch.where(any_valid, 0.0, 1.0 / nK))
    dp = torch.einsum("bqhd,bkd->bhqk", dout, v)
    if dropout_rate > 0:
        g = torch.where(dropout_keep(seed, B, H, nQ, nK, dropout_rate),
                        1.0 / (1.0 - dropout_rate), 0.0).to(e.dtype)
        dp = g * dp
        eg = e * g
    else:
        eg = e
    D = (dout * out).sum(-1).permute(0, 2, 1)[..., None]
    ds = torch.where(valid, e * (dp - D), 0.0)
    del e, dp
    dq = torch.einsum("bhqk,bkd->bqhd", ds, k)
    dtables = []
    for c in range(8):
        dt = ds.new_zeros(n * H, n * n)
        for q0 in range(0, nQ, TABLE_CHUNK):
            q1 = min(q0 + TABLE_CHUNK, nQ)
            dx, dy, dz = _deltas(corners[:, q0:q1], angles[:, q0:q1],
                                 key_xyz, c, rotate)
            wx, wy, wz = (_hats(log_quantize(d, log_scale, max_value), n)
                          for d in (dx, dy, dz))
            yx = (wy[..., :, None] * wx[..., None, :]).reshape(-1, n * n)
            zd = (wz[..., :, None] * ds[:, :, q0:q1].permute(0, 2, 3, 1)
                  [..., None, :]).reshape(-1, n * H)
            dt += zd.t() @ yx
        dtables.append(dt.reshape(n, H, n, n).permute(0, 2, 3, 1))
    return dq, torch.stack(dtables), ds, eg


TABLE_CHUNK = 64  # queries a chunk of the table gradient's contraction


def _hats(p, n: int):
    """(..., n) linear-interpolation weights of samples p in [-1, 1] on n
    grid points (align_corners=False; points off the grid weigh 0): the
    trilinear weights of `trilinear_taps` are the products of three."""
    i = ((p + 1.0) * n - 1.0) * 0.5
    f = torch.floor(i)
    t = (i - f)[..., None]
    grid = torch.arange(n, device=p.device, dtype=p.dtype)
    f = f[..., None]
    return (torch.where(grid == f, 1.0 - t, 0.0)
            + torch.where(grid == f + 1, t, 0.0))


class _RPEAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, tables, corners, angles, key_xyz, key_valid,
                seed, opts):
        out, lse, logits = rpe_attention(q, k, v, corners, angles, key_xyz,
                                         tables, key_valid, seed=seed,
                                         return_stats=True, **opts)
        ctx.save_for_backward(q, k, v, corners, angles, key_xyz, key_valid,
                              seed, out, lse, logits)
        ctx.opts = opts
        ctx.n = tables.shape[1]
        return out

    @staticmethod
    def backward(ctx, dout):
        (q, k, v, corners, angles, key_xyz, key_valid, seed, out, lse,
         logits) = ctx.saved_tensors
        dq, dtables, ds, eg = rpe_attention_bwd(
            k, v, corners, angles, key_xyz, key_valid, out,
            dout.contiguous(), logits, lse, ctx.n, seed=seed, **ctx.opts)
        dk = torch.einsum("bhqk,bqhd->bkd", ds, q)
        dv = torch.einsum("bhqk,bqhd->bkd", eg, dout)
        return dq, dk, dv, dtables, None, None, None, None, None, None


# --------------------------------------------------------------------------
# decoder
# --------------------------------------------------------------------------

def compute_predicted_angle(angle_logits, angle_residual, num_angle_bin,
                            zero_angle=False, cls=None):
    """(angle, angle_prob); `cls`, when given, replaces the argmax of the
    angle classes (`angle_margin` judges it)."""
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
    if cls is None:
        cls = prob.argmax(dim=-1)
    res = angle_residual.gather(-1, cls[..., None])[..., 0]
    angle = per_cls * cls + res
    angle = torch.where(angle > np.pi, angle - 2 * np.pi, angle)
    return angle, angle_prob


def angle_classes(angle_logits):
    """The angle class of each box, the first among equal ones."""
    return torch.softmax(angle_logits, dim=-1).argmax(dim=-1)


def class_margin(logits, values, cls):
    """The largest logit by which another class beats `cls`, over the
    boxes: 0 where `cls` takes the largest of `values`, what the argmax
    compares (sigmoid values saturate to equal, and the first index
    wins)."""
    logits = logits.detach()
    taken = values.detach().gather(-1, cls[..., None])[..., 0]
    gap = logits.amax(dim=-1) - logits.gather(-1, cls[..., None])[..., 0]
    return torch.where(taken >= values.detach().amax(dim=-1), 0.0,
                       gap).amax()


def angle_margin(angle_logits, cls):
    """`class_margin` of the angle classes `cls`."""
    return class_margin(angle_logits, torch.softmax(angle_logits, dim=-1),
                        cls)


def refine_box_predictions(heads_out, pre_center_normalized,
                           pre_size_normalized, point_cloud_dims,
                           num_angle_bin, use_focal, angle_cls=None):
    """Head outputs -> box predictions; `angle_cls`, when given, the
    boxes' angle classes (the program's), judged by `angle_margin`."""
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
    rotated = angle_logits.shape[-1] > 1
    if rotated and angle_cls is None:
        angle_cls = angle_classes(angle_logits)
    angle, angle_prob = compute_predicted_angle(angle_logits, angle_residual,
                                                num_angle_bin, cls=angle_cls)
    corners = box_parametrization_to_corners(center_un, size_un, angle)
    angle_zero, _ = compute_predicted_angle(angle_logits, angle_residual,
                                            num_angle_bin, zero_angle=True)
    corners_aa = box_parametrization_to_corners(center_un, size_un,
                                                angle_zero)
    if use_focal:
        semcls_prob = cls_logits.detach()
        obj_prob = torch.sigmoid(semcls_prob).max(dim=-1).values
    else:
        prob = torch.softmax(cls_logits.detach(), dim=-1)
        semcls_prob, obj_prob = prob[..., :-1], 1.0 - prob[..., -1]
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
        "angle_cls": angle_cls if rotated else None,
        "angle_margin": (angle_margin(angle_logits, angle_cls) if rotated
                         else torch.zeros((), device=angle.device)),
    }


class MultiHeadSelfAttention(nn.Module):
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


class GlobalShareCrossAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, rpe_dim: int,
                 rpe_quant: str, log_scale: float, angle_type: str,
                 dropout: float):
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
        self.register_buffer("coords_table", torch.from_numpy(
            make_coords_table(self.max_value, self.num_points)),
            persistent=False)

    def rpe_tables(self):
        n = self.num_points
        return torch.stack([
            mlp(self.coords_table).reshape(n, n, n, self.num_heads)
            for mlp in self.cpb_mlps])

    def forward(self, query, key, reference_point, reference_angle, key_xyz,
                key_valid=None, generator=None):
        B, nQ, D = query.shape
        H = self.num_heads
        hd = D // H
        q = self.q(query).reshape(B, nQ, H, hd) * (hd ** -0.5)
        rate = self.dropout if self.training else 0.0
        seed = torch.zeros(1, dtype=torch.int64, device=q.device)
        if rate > 0:
            seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=generator.device)
        opts = dict(log_scale=self.log_scale, max_value=self.max_value,
                    rotate=self.rotate, dropout_rate=rate)
        args = (q.contiguous(), self.k(key).contiguous(),
                self.v(key).contiguous(), self.rpe_tables().contiguous(),
                reference_point.contiguous(), reference_angle.contiguous(),
                key_xyz.contiguous(), key_valid, seed)
        if torch.is_grad_enabled():
            out = _RPEAttention.apply(*args, opts)
        else:
            q_, k_, v_, tables, corners, angles, kxyz, kv, sd = args
            out = rpe_attention(q_, k_, v_, corners, angles, kxyz, tables,
                                kv, seed=sd, **opts)
        return self.proj_drop(self.proj(out.reshape(B, nQ, D)), generator)


class FFNLayer(nn.Module):
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
    def __init__(self, c):
        super().__init__()
        self.norm1 = nn.LayerNorm(c.dec_dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(c.dec_dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(c.dec_dim, eps=LN_EPS)
        self.self_attn = MultiHeadSelfAttention(c.dec_dim, c.dec_nhead,
                                                c.dec_dropout)
        self.multihead_attn = GlobalShareCrossAttention(
            c.dec_dim, c.dec_nhead, c.rpe_dim, c.rpe_quant, c.log_scale,
            c.angle_type, c.dec_dropout)
        self.linear1 = nn.Linear(c.dec_dim, c.dec_ffn_dim)
        self.linear2 = nn.Linear(c.dec_ffn_dim, c.dec_dim)
        self.dropout1, self.dropout2, self.dropout3, self.dropout4 = (
            Dropout(c.dec_dropout) for _ in range(4))

    def forward(self, tgt, memory, reference_point, reference_angle,
                enc_xyz, query_pos, key_valid=None, generator=None):
        t2 = self.norm1(tgt)
        q = t2 + query_pos
        tgt = tgt + self.dropout1(self.self_attn(q, q, t2, generator),
                                  generator)
        t2 = self.norm2(tgt)
        ca = self.multihead_attn(t2 + query_pos, memory, reference_point,
                                 reference_angle, enc_xyz, key_valid,
                                 generator)
        tgt = tgt + self.dropout2(ca, generator)
        t2 = self.norm3(tgt)
        h = self.dropout3(F.relu(self.linear1(t2)), generator)
        return tgt + self.dropout4(self.linear2(h), generator)


_HEADS = ("sem_cls", "center", "size", "angle_cls", "angle_residual")


class BoxHeads(nn.Module):
    def __init__(self, c, num_semcls: int, num_angle_bin: int):
        super().__init__()
        outs = dict(sem_cls=num_semcls, center=3, size=3,
                    angle_cls=num_angle_bin, angle_residual=num_angle_bin)
        for h in _HEADS:
            self.add_module(f"{h}_head", GenericMLP(
                c.dec_dim, [c.dec_dim, c.dec_dim], outs[h],
                dropout=c.mlp_dropout, norm=c.mlp_norm,
                activation=c.mlp_act))

    def forward(self, x, generator=None) -> Dict[str, torch.Tensor]:
        return {h: getattr(self, f"{h}_head")(x, generator) for h in _HEADS}


def select_proposals(obj, nq: int):
    """The nq largest scores, largest first, the lower index first among
    equal scores."""
    return torch.sort(obj, dim=1, descending=True, stable=True).indices[:, :nq]


class TransformerDecoder(nn.Module):
    def __init__(self, c, num_semcls: int, num_angle_bin: int):
        super().__init__()
        self.cfg = c
        self.num_semcls = num_semcls
        self.num_angle_bin = num_angle_bin
        num_layers = c.dec_nlayers - 1
        self.first_layer = FFNLayer(c.dec_dim, c.dec_ffn_dim, c.dec_dropout)
        self.norm = nn.LayerNorm(c.dec_dim, eps=LN_EPS)
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
        out = num_semcls if c.use_focal else num_semcls + 1
        self.pointcls_heads = GenericMLP(
            c.dec_dim, [c.dec_dim, c.dec_dim], out, dropout=c.mlp_dropout,
            norm=c.mlp_norm, activation=c.mlp_act)

    def forward(self, enc_features, enc_xyz, point_cloud_dims,
                enc_box_predictions, enc_valid=None, generator=None,
                topk=None, proposals_only=False, angle_cls=None):
        """`topk` (B, nq), when given, replaces the proposals' choice, and
        `angle_cls` (one (B, n) tensor a prediction, layer 0 first) the
        angle classes; `proposals_only`: stop at the choice."""
        c = self.cfg
        given = list(angle_cls) if angle_cls else []
        output = self.first_layer(enc_features, generator)
        pred0 = refine_box_predictions(
            self.mlp_heads[0](self.norm(output), generator),
            enc_box_predictions["center_normalized"],
            enc_box_predictions["size_normalized"],
            point_cloud_dims, self.num_angle_bin, c.use_focal,
            given.pop(0) if given else None)
        intermediate: List[Dict[str, torch.Tensor]] = [pred0]
        obj = pred0["objectness_prob"]
        if enc_valid is not None:
            obj = torch.where(enc_valid, obj, -torch.inf)
        nq = min(c.nqueries, obj.shape[1])
        if topk is None:
            topk = select_proposals(obj, nq)
        if proposals_only:
            return {"topk": topk, "proposal_scores": obj}

        def g(x):
            idx = topk.reshape(topk.shape + (1,) * (x.ndim - 2))
            return x.gather(1, idx.expand((-1, -1) + x.shape[2:]))

        sg = {k: pred0[k].detach() for k in (
            "box_corners", "center_unnormalized", "size_unnormalized",
            "angle_continuous", "center_normalized", "size_normalized")}
        reference_point = convert_corners_camera2lidar(g(sg["box_corners"]))
        reference_center = g(sg["center_unnormalized"])
        reference_size = g(sg["size_unnormalized"])
        reference_angle = g(sg["angle_continuous"])
        proposal_center_norm = g(sg["center_normalized"])
        proposal_size_norm = g(sg["size_normalized"])
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
                    box_prediction["box_corners"].detach())
                reference_center = \
                    box_prediction["center_unnormalized"].detach()
                reference_size = box_prediction["size_unnormalized"].detach()
                reference_angle = box_prediction["angle_continuous"].detach()
            query_pos = self.query_pos_projection[idx](
                torch.cat([reference_center, reference_size], dim=-1))
            output = layer(output, enc_features, reference_point,
                           reference_angle, enc_xyz, query_pos, enc_valid,
                           generator)
            box_prediction = refine_box_predictions(
                self.mlp_heads[idx + 1](self.norm(output), generator),
                proposal_center_norm, proposal_size_norm, point_cloud_dims,
                self.num_angle_bin, c.use_focal,
                given.pop(0) if given else None)
            intermediate.append(box_prediction)
        return {"outputs": intermediate[-1],
                "aux_outputs": intermediate[:-1], "topk": topk,
                "proposal_scores": obj,
                "angle_cls": [p["angle_cls"] for p in intermediate
                              if p["angle_cls"] is not None],
                "angle_margin": torch.stack(
                    [p["angle_margin"] for p in intermediate]).amax()}
