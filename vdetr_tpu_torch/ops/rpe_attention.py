"""Vertex-RPE cross-attention and its gradient: the wrappers of the Hopper
kernels `csrc/rpe_attention.cu` (forward) and `csrc/rpe_attention_bwd.cu`
(flash backward), their plain PyTorch versions, and the autograd
Function that joins them.

Replaces the TPU kernels `vdetr_tpu/ops/rpe_attention.py:
rpe_cross_attention_pallas` and `_flash_bwd_impl`; the contract is
`rpe_cross_attention_reference` and its vjp: logits `q . k` plus, for
each of the 8 box corners, the trilinearly sampled table bias of the
log-quantized corner-to-key delta (optionally rotated into the object
frame); masked keys get -1e9; softmax over keys; average of the shared
V head.

Training adds attention dropout after the softmax, on the numerator only
(the Pallas kernel's form): p -> p * keep / (1 - rate), where keep is a
counter hash of (seed, batch, head, query, key) (`dropout_keep`) that
the forward and the backward both evaluate. The training forward also
returns the row log-sum-exp (0 for a batch row whose keys are all
masked) and the masked logits, which the backward reads. Gradients flow
to q, k, v and the tables only: corners, angles and key positions are
detached boxes and lattice points in the decoder.

What bounds each kernel on the H100, and how its design answers it, is
in the source notes of the two `.cu` files.
"""

from __future__ import annotations

import torch

from vdetr_tpu_torch import kernels
from vdetr_tpu_torch.ops.rpe import (log_quantize, trilinear_sample,
                                     trilinear_taps)

NEG_INF = -1e9
_KERNEL_HEADS = 4
_KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
# the backward's pair kernel (csrc/rpe_attention_bwd.cu): a block takes
# 16 queries and its keys in 32-key tiles; at most 8 key shares, whose
# partial dQ a second kernel adds in share order
_PAIR_QUERIES = 16
_PAIR_KEYS = 32
_PAIR_MAX_SHARES = 8
# its table kernel: a block takes 32 queries, one corner pair and a share
# of the keys, 2 blocks an SM
_TABLE_QUERIES = 32
_TABLE_BLOCKS_PER_SM = 2
_U32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# attention dropout: the counter hash of csrc/rpe_common.cuh in int64 ops
# --------------------------------------------------------------------------

def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    return (x * (c & 0xFFFF) + ((x * (c >> 16)) & 0xFFFF) * 65536) & _U32


def _hash32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    """A key is kept iff its 24-bit hash is >= this."""
    return int(rate * (1 << 24))


def dropout_keep(seed, B: int, H: int, nQ: int, nK: int, rate: float,
                 key_offset: int = 0):
    """(B, H, nQ, nK) bool keep mask of attention dropout at `rate`;
    `seed` an int64 tensor of one element. Both kernels evaluate the same
    hash: row = (b * H + h) * nQ + q, x = hash(hash(seed ^ hash(row)) ^
    key * 0x9E3779B1), keep iff x >> 8 >= floor(rate * 2^24), with key
    the global key index, `key_offset` + the local one: a key shard's
    mask is then the dense mask's slice."""
    dev = seed.device
    row = torch.arange(B * H * nQ, dtype=torch.int64, device=dev)
    rowh = _hash32((seed.reshape(()) & _U32) ^ _hash32(row))
    key = _mul32(torch.arange(key_offset, key_offset + nK, dtype=torch.int64,
                              device=dev) & _U32, 0x9E3779B1)
    x = _hash32(rowh[:, None] ^ key[None, :])
    return ((x >> 8) >= keep_threshold(rate)).reshape(B, H, nQ, nK)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _deltas(corners, angles, key_xyz, c: int, rotate: bool):
    """Corner c's (dx, dy, dz) to every key, (B, nQ, nK) each, rotated
    into the object frame when `rotate`."""
    corner = corners[:, :, c, :]
    dx = corner[:, :, 0:1] - key_xyz[:, None, :, 0]
    dy = corner[:, :, 1:2] - key_xyz[:, None, :, 1]
    dz = corner[:, :, 2:3] - key_xyz[:, None, :, 2]
    if rotate:
        co = torch.cos(angles)[..., None]
        si = torch.sin(angles)[..., None]
        dx, dy = dx * co - dy * si, dx * si + dy * co
    return dx, dy, dz


def _corner_taps(corners, angles, key_xyz, c, rotate, log_scale, max_value,
                 n):
    dx, dy, dz = _deltas(corners, angles, key_xyz, c, rotate)
    return trilinear_taps(log_quantize(dx, log_scale, max_value),
                          log_quantize(dy, log_scale, max_value),
                          log_quantize(dz, log_scale, max_value), n)


def rpe_cross_attention_plain(q, k, v, corners, angles, key_xyz, tables,
                              key_valid=None, *, log_scale: float,
                              max_value: float, rotate: bool = False,
                              dropout_rate: float = 0.0, seed=None,
                              return_stats: bool = False,
                              return_lse: bool = False, key_offset: int = 0):
    """Plain version with the (B, H, nQ, nK) logits materialized. With
    return_stats, returns (out, lse (B, nQ, H), masked logits); with
    return_lse, (out, lse)."""
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
    if key_valid is not None:
        attn = torch.where(key_valid[:, None, None, :], attn, NEG_INF)
    p = torch.softmax(attn, dim=-1)
    if dropout_rate > 0:
        scale = torch.tensor(1.0 / (1.0 - dropout_rate), dtype=p.dtype)
        p = torch.where(dropout_keep(seed, B, H, nQ, nK, dropout_rate,
                                     key_offset),
                        p * scale.to(p.device), 0.0)
    out = torch.einsum("bhqk,bkd->bqhd", p, v)
    if not (return_stats or return_lse):
        return out
    lse = torch.logsumexp(attn, dim=-1).permute(0, 2, 1)
    if key_valid is not None:
        lse = torch.where(key_valid.any(dim=1)[:, None, None], lse, 0.0)
    if not return_stats:
        return out, lse.contiguous()
    return out, lse.contiguous(), attn


def _check_heads(H, hd):
    if H != _KERNEL_HEADS or hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the RPE kernels are built for {_KERNEL_HEADS} "
                         f"heads of width {_KERNEL_HEAD_DIMS}; got H={H}, "
                         f"hd={hd}")


def _cossin(angles, rotate):
    return (torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)
            .contiguous() if rotate else None)


def _dropout_args(dropout_rate, seed):
    """(seed pointer or None, keep threshold, scale) for the kernels."""
    if dropout_rate <= 0:
        return None, 0, 1.0
    kernels.check(seed, torch.int64, (1,), "seed")
    return seed.data_ptr(), keep_threshold(dropout_rate), \
        1.0 / (1.0 - dropout_rate)


def rpe_cross_attention(q, k, v, corners, angles, key_xyz, tables,
                        key_valid=None, *, log_scale: float,
                        max_value: float, rotate: bool = False,
                        dropout_rate: float = 0.0, seed=None,
                        return_stats: bool = False, return_lse: bool = False,
                        key_offset: int = 0):
    """q (B, nQ, H, hd) pre-scaled by hd^-0.5; k, v (B, nK, hd);
    corners (B, nQ, 8, 3); angles (B, nQ); key_xyz (B, nK, 3); tables
    (8, n, n, n, H); key_valid (B, nK) bool or None; seed an int64
    tensor (1,) on q's device when dropout_rate > 0. Returns (B, nQ, H,
    hd) float32, and with return_stats also the row log-sum-exp (B, nQ,
    H) and the masked logits (B, H, nQ, nK) for the backward; with
    return_lse, (out, lse) and no logits. `key_offset`: the global index
    of the first key, which the dropout hash reads (a key shard's mask is
    the dense mask's slice; 0: the dense keys).

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors take
    `rpe_cross_attention_plain`."""
    kw = dict(log_scale=log_scale, max_value=max_value, rotate=rotate,
              dropout_rate=dropout_rate, seed=seed, return_stats=return_stats,
              return_lse=return_lse, key_offset=key_offset)
    if not q.is_cuda:
        return rpe_cross_attention_plain(q, k, v, corners, angles, key_xyz,
                                         tables, key_valid, **kw)
    B, nQ, H, hd = q.shape
    nK = k.shape[1]
    n = tables.shape[1]
    _check_heads(H, hd)
    f32 = torch.float32
    kernels.check(q, f32, (B, nQ, H, hd), "q")
    kernels.check(k, f32, (B, nK, hd), "k")
    kernels.check(v, f32, (B, nK, hd), "v")
    kernels.check(corners, f32, (B, nQ, 8, 3), "corners")
    kernels.check(key_xyz, f32, (B, nK, 3), "key_xyz")
    kernels.check(tables, f32, (8, n, n, n, H), "tables")
    if key_valid is not None:
        kernels.check(key_valid, torch.bool, (B, nK), "key_valid")
    cossin = _cossin(angles, rotate)
    if cossin is not None:
        kernels.check(cossin, f32, (B, nQ, 2), "angles")
    seed_ptr, threshold, scale = _dropout_args(dropout_rate, seed)
    out = torch.empty_like(q)
    lse = logits = None
    if return_stats or return_lse:
        lse = torch.empty(B, nQ, H, dtype=f32, device=q.device)
    if return_stats:
        logits = torch.empty(B, H, nQ, nK, dtype=f32, device=q.device)
    kernels.call(
        "rpe_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        corners.data_ptr(), None if cossin is None else cossin.data_ptr(),
        key_xyz.data_ptr(), tables.data_ptr(),
        None if key_valid is None else key_valid.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if logits is None else logits.data_ptr(), seed_ptr,
        B, nQ, nK, H, hd, n, float(log_scale), float(max_value), int(rotate),
        threshold, scale, int(key_offset),
        torch.cuda.current_stream(q.device).cuda_stream)
    rpe_cross_attention.launches += 1
    if return_stats:
        return out, lse, logits
    return (out, lse) if return_lse else out


rpe_cross_attention.launches = 0


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------

def rpe_cross_attention_bwd_plain(k, v, corners, angles, key_xyz, key_valid,
                                  out, dout, logits, lse, n: int, *,
                                  log_scale: float, max_value: float,
                                  rotate: bool = False,
                                  dropout_rate: float = 0.0, seed=None,
                                  key_offset: int = 0):
    """Plain version of the flash backward: (dq, dtables, ds, eg), the
    function the source note of `csrc/rpe_attention_bwd.cu` states."""
    B, nQ, H, _ = dout.shape
    nK = k.shape[1]
    lse_h = lse.permute(0, 2, 1)[..., None]                   # (B, H, nQ, 1)
    if key_valid is None:
        key_valid = torch.ones(B, nK, dtype=torch.bool, device=k.device)
    valid = key_valid[:, None, None, :]
    any_valid = key_valid.any(dim=1)[:, None, None, None]
    e = torch.where(valid, torch.exp(logits - lse_h),
                    torch.where(any_valid, 0.0, 1.0 / nK))
    dp = torch.einsum("bqhd,bkd->bhqk", dout, v)
    if dropout_rate > 0:
        g = torch.where(dropout_keep(seed, B, H, nQ, nK, dropout_rate,
                                     key_offset),
                        1.0 / (1.0 - dropout_rate), 0.0).to(e.dtype)
        dp = g * dp
        eg = e * g
    else:
        eg = e
    D = (dout * out).sum(-1).permute(0, 2, 1)[..., None]     # (B, H, nQ, 1)
    ds = torch.where(valid, e * (dp - D), 0.0)
    dq = torch.einsum("bhqk,bkd->bqhd", ds, k)
    ds_cell = ds.permute(0, 2, 3, 1).reshape(-1, H)          # (B nQ nK, H)
    dtables = []
    for c in range(8):
        dt = ds.new_zeros(n ** 3, H)
        for cell, w in _corner_taps(corners, angles, key_xyz, c, rotate,
                                    log_scale, max_value, n):
            dt.index_add_(0, cell.reshape(-1), ds_cell * w.reshape(-1, 1))
        dtables.append(dt.reshape(n, n, n, H))
    return dq, torch.stack(dtables), ds, eg


def pair_key_split(B: int, nQ: int, nK: int, hd: int, sms: int = 132):
    """(keys a block, key shares) of the backward's pair kernel: of 1 to
    8 shares, the one with the fewest waves (over `sms` SMs at the blocks
    resident an SM, 3 at head widths up to 64 and 1 above, as the
    kernel's launch bounds give) times 32-key tiles a block, the fewer
    shares on ties."""
    blocks = B * -(-nQ // _PAIR_QUERIES)
    ktiles = max(1, -(-nK // _PAIR_KEYS))
    slots = sms * (3 if hd <= 64 else 1)
    best, best_cost = 1, None
    for s in range(1, min(ktiles, _PAIR_MAX_SHARES) + 1):
        cost = -(-blocks * s // slots) * -(-ktiles // s)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    per_block = -(-ktiles // best) * _PAIR_KEYS
    return per_block, -(-nK // per_block)


def table_key_split(B: int, nQ: int, nK: int, sms: int = 132):
    """(keys a block, key shares) of the backward's table kernel: the
    keys split in 32-key chunks over as many shares as fill the card's
    `sms` SMs at 2 blocks an SM, with 4 corner pairs per (batch row,
    32-query tile); at least one share, at least one chunk a share."""
    chunks = max(1, -(-nK // 32))
    blocks = B * -(-nQ // _TABLE_QUERIES) * 4
    shares = max(1, min(chunks, _TABLE_BLOCKS_PER_SM * sms // blocks))
    per_block = -(-chunks // shares) * 32
    return per_block, -(-max(nK, 1) // per_block)


def rpe_table_sum_plain(slices):
    """Plain version of `rpe_table_sum`: the slices added in order."""
    out = slices[0].clone()
    for s in slices[1:]:
        out = out + s
    return out


def rpe_table_sum(slices):
    """dTables (8, n, n, n, H) from the table kernel's slices (count, 8,
    n, n, n, H): added in slice order, the same bits in every run.

    CUDA tensors launch the Hopper kernel `csrc/rpe_table_sum.cu` (or
    raise); CPU tensors take `rpe_table_sum_plain`."""
    if not slices.is_cuda:
        return rpe_table_sum_plain(slices)
    kernels.check(slices, torch.float32, slices.shape, "slices")
    if slices.dim() != 6 or slices.shape[1] != 8 or slices.shape[0] < 1:
        raise ValueError(f"slices: want (count, 8, n, n, n, H), got "
                         f"{tuple(slices.shape)}")
    out = torch.empty(slices.shape[1:], dtype=torch.float32,
                      device=slices.device)
    kernels.call("rpe_table_sum", slices.data_ptr(), out.data_ptr(),
                 out.numel(), slices.shape[0],
                 torch.cuda.current_stream(slices.device).cuda_stream)
    rpe_table_sum.launches += 1
    return out


rpe_table_sum.launches = 0


def rpe_cross_attention_bwd(k, v, corners, angles, key_xyz, key_valid, out,
                            dout, logits, lse, n: int, *, log_scale: float,
                            max_value: float, rotate: bool = False,
                            dropout_rate: float = 0.0, seed=None,
                            key_offset: int = 0):
    """The flash backward from the training forward's logits and lse:
    returns dq (B, nQ, H, hd), dtables (8, n, n, n, H), ds and eg (B, H,
    nQ, nK), with dK = sum_h ds^T q and dV = sum_h eg^T dout left to the
    caller.

    CUDA tensors launch the Hopper kernels (or raise), the table kernel's
    slices added by `rpe_table_sum`: dq, dtables, ds and eg are the same
    bits from call to call; CPU tensors take
    `rpe_cross_attention_bwd_plain`."""
    kw = dict(log_scale=log_scale, max_value=max_value, rotate=rotate,
              dropout_rate=dropout_rate, seed=seed, key_offset=key_offset)
    if not dout.is_cuda:
        return rpe_cross_attention_bwd_plain(k, v, corners, angles, key_xyz,
                                             key_valid, out, dout, logits,
                                             lse, n, **kw)
    B, nQ, H, hd = dout.shape
    nK = k.shape[1]
    _check_heads(H, hd)
    f32 = torch.float32
    kernels.check(k, f32, (B, nK, hd), "k")
    kernels.check(v, f32, (B, nK, hd), "v")
    kernels.check(corners, f32, (B, nQ, 8, 3), "corners")
    kernels.check(key_xyz, f32, (B, nK, 3), "key_xyz")
    kernels.check(out, f32, (B, nQ, H, hd), "out")
    kernels.check(dout, f32, (B, nQ, H, hd), "dout")
    kernels.check(logits, f32, (B, H, nQ, nK), "logits")
    kernels.check(lse, f32, (B, nQ, H), "lse")
    if key_valid is not None:
        kernels.check(key_valid, torch.bool, (B, nK), "key_valid")
    cossin = _cossin(angles, rotate)
    seed_ptr, threshold, scale = _dropout_args(dropout_rate, seed)
    dev = dout.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_block, shares = pair_key_split(B, nQ, nK, hd, sms)
    table_per_block, table_shares = table_key_split(B, nQ, nK, sms)
    dq = torch.empty_like(dout)
    dq_parts = (torch.empty(shares, B, nQ, H, hd, dtype=f32, device=dev)
                if shares > 1 else None)
    # one max |ds| per pair block, one slice of the tables per table block
    # row (batch row, 32-query tile, key share)
    ds_absmax = torch.empty(-(-nQ // _PAIR_QUERIES) * B * shares, dtype=f32,
                            device=dev)
    slices = torch.empty(B * -(-nQ // _TABLE_QUERIES) * table_shares, 8, n,
                         n, n, H, dtype=f32, device=dev)
    ds = torch.empty(B, H, nQ, nK, dtype=f32, device=dev)
    eg = torch.empty(B, H, nQ, nK, dtype=f32, device=dev)
    kernels.call(
        "rpe_attention_bwd", k.data_ptr(), v.data_ptr(), corners.data_ptr(),
        None if cossin is None else cossin.data_ptr(), key_xyz.data_ptr(),
        None if key_valid is None else key_valid.data_ptr(), out.data_ptr(),
        dout.data_ptr(), logits.data_ptr(), lse.data_ptr(), seed_ptr,
        dq.data_ptr(), None if dq_parts is None else dq_parts.data_ptr(),
        ds_absmax.data_ptr(), slices.data_ptr(), ds.data_ptr(), eg.data_ptr(),
        B, nQ, nK, H, hd, n, float(log_scale), float(max_value), int(rotate),
        threshold, scale, int(key_offset), per_block, table_per_block,
        torch.cuda.current_stream(dev).cuda_stream)
    rpe_cross_attention_bwd.launches += 1
    dtables = (rpe_table_sum(slices) if nK > 0 and B > 0 and nQ > 0 else
               torch.zeros(8, n, n, n, H, dtype=f32, device=dev))
    return dq, dtables, ds, eg


rpe_cross_attention_bwd.launches = 0


class _RPECrossAttention(torch.autograd.Function):
    """The training forward and the flash backward (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, tables, corners, angles, key_xyz, key_valid,
                seed, opts):
        out, lse, logits = rpe_cross_attention(
            q, k, v, corners, angles, key_xyz, tables, key_valid,
            seed=seed, return_stats=True, **opts)
        ctx.save_for_backward(q, k, v, corners, angles, key_xyz, key_valid,
                              seed, out, lse, logits)
        ctx.opts = opts
        ctx.n = tables.shape[1]
        return out

    @staticmethod
    def backward(ctx, dout):
        (q, k, v, corners, angles, key_xyz, key_valid, seed, out, lse,
         logits) = ctx.saved_tensors
        dq, dtables, ds, eg = rpe_cross_attention_bwd(
            k, v, corners, angles, key_xyz, key_valid, out,
            dout.contiguous(), logits, lse, ctx.n, seed=seed, **ctx.opts)
        dk = torch.einsum("bhqk,bqhd->bkd", ds, q)
        dv = torch.einsum("bhqk,bqhd->bkd", eg, dout)
        return dq, dk, dv, dtables, None, None, None, None, None, None


def rpe_cross_attention_ad(q, k, v, corners, angles, key_xyz, tables,
                           key_valid=None, *, log_scale: float,
                           max_value: float, rotate: bool = False,
                           dropout_rate: float = 0.0, seed=None):
    """Differentiable `rpe_cross_attention` (same arguments): gradients
    for q, k, v and tables through the flash backward."""
    if seed is None:
        seed = torch.zeros(1, dtype=torch.int64, device=q.device)
    opts = dict(log_scale=log_scale, max_value=max_value, rotate=rotate,
                dropout_rate=dropout_rate)
    return _RPECrossAttention.apply(q, k, v, tables, corners, angles,
                                    key_xyz, key_valid, seed, opts)


# --------------------------------------------------------------------------
# key-sharded form: kernel C on each shard, the shards merged by their
# log-sum-exps; kernel F on each shard from the global out and lse
# --------------------------------------------------------------------------

def shard_merge(out, lse, key_valid, nK: int, reduce_sum, reduce_max):
    """The global (out, lse) from each key shard's kernel-C output over
    its own nK keys: LSE = log sum_s exp(lse_s), by a max and then a sum
    over the shards; out = sum_s exp(lse_s - LSE) out_s. `reduce_sum` /
    `reduce_max` reduce over the shards: all-reduces over a seq group, or,
    for shards stacked on a leading axis in one process, sums and maxima
    over it (keepdim). out (..., B, nQ, H, hd), lse (..., B, nQ, H),
    key_valid (..., B, nK) or None. A shard whose keys are all masked in
    a batch row weighs 0 there when another shard has a valid key (its
    lse is written as 0, which must not count: JAX's `m_safe`), and
    nK_s / nK when no shard has one, where the dense kernel averages V
    over every key. Returns (out, LSE, the per-row scale of the shard's
    cotangent in the backward: 1, or its weight where it has no valid
    key)."""
    B = lse.shape[-3]
    local_any = (torch.ones(lse.shape[:-2], dtype=torch.bool,
                            device=lse.device)
                 if key_valid is None else key_valid.any(dim=-1))
    meta = reduce_sum(torch.cat([local_any.float(), torch.full(
        lse.shape[:-3] + (1,), float(nK), device=lse.device)], dim=-1))
    global_any, share = meta[..., :B] > 0, float(nK) / meta[..., B:]
    rows = lambda m: m[..., None, None]  # noqa: E731 (B,) -> (B, 1, 1)
    lse_eff = torch.where(rows(local_any), lse,
                          torch.where(rows(global_any), -torch.inf,
                                      rows(torch.log(share))))
    m = reduce_max(lse_eff)
    LSE = m + torch.log(reduce_sum(torch.exp(lse_eff - m)))
    merged = reduce_sum(torch.exp(lse_eff - LSE)[..., None] * out)
    scale = torch.where(local_any, 1.0,
                        torch.where(global_any, 0.0, share))
    return merged, LSE, scale


def shard_backward(q, k, v, corners, angles, key_xyz, key_valid, out, lse,
                   logits, scale, dout, n: int, seed, opts):
    """Kernel F on one key shard from the global out and lse and the
    cotangent of the merged out (summed over the ranks that read it),
    scaled per row by `shard_merge`'s scale (0, or nK_s / nK, which F's
    uniform 1 / nK_s over a row with no valid key then makes 1 / nK):
    this shard's share of dQ and the tables' gradient, and its dK, dV."""
    dout = (dout * scale[:, None, None, None]).contiguous()
    dq, dtables, ds, eg = rpe_cross_attention_bwd(
        k, v, corners, angles, key_xyz, key_valid, out, dout, logits, lse,
        n, seed=seed, **opts)
    dk = torch.einsum("bhqk,bqhd->bkd", ds, q)
    dv = torch.einsum("bhqk,bqhd->bkd", eg, dout)
    return dq, dk, dv, dtables


def _group_reductions(group):
    from vdetr_tpu_torch.parallel import dist

    return (lambda x: dist.all_reduce_sum(x, group),
            lambda x: dist.all_reduce_max(x, group))


class _ShardedRPE(torch.autograd.Function):
    """Forward: kernel C on this rank's keys (lse and logits kept), the
    shards merged (`shard_merge`). Backward: the cotangent of the merged
    out summed over the group (each rank's loss reads its own copy of the
    sum), then kernel F on this rank's keys (`shard_backward`)."""

    @staticmethod
    def forward(ctx, q, k, v, tables, corners, angles, key_xyz, key_valid,
                seed, opts, group):
        out, lse, logits = rpe_cross_attention(
            q, k, v, corners, angles, key_xyz, tables, key_valid,
            seed=seed, return_stats=True, **opts)
        merged, LSE, scale = shard_merge(out, lse, key_valid, k.shape[1],
                                         *_group_reductions(group))
        ctx.save_for_backward(q, k, v, corners, angles, key_xyz, key_valid,
                              seed, merged, LSE, logits, scale)
        ctx.opts, ctx.group, ctx.n = opts, group, tables.shape[1]
        return merged

    @staticmethod
    def backward(ctx, dout):
        from vdetr_tpu_torch.parallel import dist

        (q, k, v, corners, angles, key_xyz, key_valid, seed, out, lse,
         logits, scale) = ctx.saved_tensors
        dq, dk, dv, dtables = shard_backward(
            q, k, v, corners, angles, key_xyz, key_valid, out, lse, logits,
            scale, dist.all_reduce_sum(dout.contiguous(), ctx.group), ctx.n,
            seed, ctx.opts)
        return (dq, dk, dv, dtables, None, None, None, None, None, None,
                None)


def sharded_rpe_cross_attention(q, k, v, corners, angles, key_xyz, tables,
                                key_valid=None, *, group, key_offset: int,
                                log_scale: float, max_value: float,
                                rotate: bool = False,
                                dropout_rate: float = 0.0, seed=None):
    """`rpe_cross_attention_ad` over keys sharded across the ranks of
    `group`: k, v, key_xyz and key_valid are this rank's shard, whose
    first key has the global index `key_offset`; q, corners, angles,
    tables and seed are the same on every rank. Returns the attention
    over all the ranks' keys, the same on every rank: the dense form's
    value, its dropout mask included (the hash reads global key
    indices). Differentiable when grad is enabled (`_ShardedRPE`); else
    only the forward runs, kernel C without its logits. CUDA tensors
    launch the kernels, CPU tensors take their plain versions."""
    if seed is None:
        seed = torch.zeros(1, dtype=torch.int64, device=q.device)
    opts = dict(log_scale=log_scale, max_value=max_value, rotate=rotate,
                dropout_rate=dropout_rate, key_offset=key_offset)
    if torch.is_grad_enabled():
        return _ShardedRPE.apply(q, k, v, tables, corners, angles, key_xyz,
                                 key_valid, seed, opts, group)
    out, lse = rpe_cross_attention(q, k, v, corners, angles, key_xyz, tables,
                                   key_valid, seed=seed, return_lse=True,
                                   **opts)
    return shard_merge(out, lse, key_valid, k.shape[1],
                       *_group_reductions(group))[0]
