"""Key-sharded ("seq") attention for large scenes (torch counterpart of
`vdetr_tpu/parallel/seq_attention.py`).

The queries (1024) are replicated over the ranks of a seq group; keys,
values and key positions are a rank's own shard. Each rank computes the
logits of its keys, a streaming-softmax partial (max, sum of exps,
weighted values), and the partials meet in all-reduces over the group:
the exact global softmax, at a traffic of O(nQ (1 + head width)) a rank,
whatever the key count.

Every function takes its group explicitly (None: one shard, the dense
function) and is differentiable through `dist.all_reduce_sum` and
`dist.all_gather_dim`, whose backwards sum the cotangents over the ranks.
The maxima that steady the exps cancel in the softmax and carry no
gradient. The decoder's cross-attention does not use these plain forms
but `ops.rpe_attention.sharded_rpe_cross_attention`, kernel C on each
shard with its shards merged by their log-sum-exps; they are the
reference's API and what that form is held to.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from vdetr_tpu_torch.parallel import dist

# a shard whose keys are all masked has max -inf; this stands in for it
M_SAFE = -1e30


def _m_safe(m):
    return torch.where(torch.isfinite(m), m, M_SAFE)


def sharded_softmax_attention(q, k_local, v_local, bias_local,
                              key_valid_local=None, group=None):
    """Streaming-softmax attention over sharded keys. q (B, H, nQ, hd);
    k_local, v_local (B, nK_loc, hd), one shared head; bias_local (B, H,
    nQ, nK_loc) additive logits; key_valid_local (B, nK_loc) bool or
    None. Returns (B, nQ, H, hd), the same on every rank of `group`."""
    logits = torch.einsum("bhqd,bkd->bhqk", q, k_local) + bias_local
    if key_valid_local is not None:
        logits = torch.where(key_valid_local[:, None, None, :], logits,
                             -torch.inf)
    m_safe = _m_safe(logits.detach().amax(dim=-1))             # (B, H, nQ)
    m_glob = dist.all_reduce_max(m_safe, group)
    p = torch.exp(logits - m_glob[..., None])
    if key_valid_local is not None:
        p = torch.where(key_valid_local[:, None, None, :], p, 0.0)
    l_glob = dist.all_reduce_sum(p.sum(-1), group)
    o_glob = dist.all_reduce_sum(
        torch.einsum("bhqk,bkd->bhqd", p, v_local), group)
    out = o_glob / l_glob[..., None].clamp(min=1e-20)
    return out.permute(0, 2, 1, 3)


def combine_sharded_logits(logits_local, v_local, group,
                           dropout_fn: Optional[Callable] = None):
    """Streaming-softmax combine of logits computed on a local key shard.
    logits_local (B, H, nQ, nK_loc), invalid keys already masked to a
    large negative; v_local (B, nK_loc, hd). `dropout_fn` (optional)
    acts on the local unnormalized exps: the same as dropping the
    normalized probabilities, since the denominator never sees it.
    Returns (B, nQ, H, hd), the same on every rank of `group`."""
    m_safe = _m_safe(logits_local.detach().amax(dim=-1))
    m_glob = dist.all_reduce_max(m_safe, group)
    p = torch.exp(logits_local - m_glob[..., None])
    l_glob = dist.all_reduce_sum(p.sum(-1), group)
    if dropout_fn is not None:
        p = dropout_fn(p)
    o_glob = dist.all_reduce_sum(torch.einsum("bhqk,bkd->bhqd", p, v_local),
                                 group)
    out = o_glob / l_glob[..., None].clamp(min=1e-20)
    return out.permute(0, 2, 1, 3)


def global_topk_sharded(scores_local, nq: int, group):
    """The global top-nq of a score axis sharded over `group`:
    scores_local (B, n_loc) on each rank. Returns (global indices (B, nq)
    int64, largest first, this rank's offset s n_loc). Among equal scores
    the lower global index comes first, as `lax.top_k` and the decoder's
    `select_proposals` (a stable descending sort) choose."""
    n_loc = scores_local.shape[1]
    scores = dist.all_gather_dim(scores_local.detach(), 1, group)
    topk = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return topk[:, :nq], dist.rank(group) * n_loc


def gather_selected_sharded(x_local, global_idx, shard_offset: int, group):
    """Rows of a key-sharded tensor at replicated global indices: x_local
    (B, n_loc, ...), global_idx (B, nq). Each rank contributes the rows
    it owns, zeros elsewhere, and a sum over the group assembles the
    replicated (B, nq, ...) result."""
    n_loc = x_local.shape[1]
    local = global_idx - shard_offset
    mine = (local >= 0) & (local < n_loc)
    idx = local.clamp(0, n_loc - 1)
    extra = (1,) * (x_local.ndim - 2)
    g = x_local.gather(1, idx.reshape(idx.shape + extra).expand(
        idx.shape + x_local.shape[2:]))
    g = torch.where(mine.reshape(mine.shape + extra), g, 0.0)
    return dist.all_reduce_sum(g, group)


def make_sharded_rpe_cross_attention(rpe_bias_fn: Callable, group=None):
    """A key-sharded attention from a local-bias function
    `rpe_bias_fn(reference_point, key_xyz_local)` -> (B, H, nQ, nK_loc).
    Returns attend(q, k_local, v_local, reference_point, key_xyz_local,
    key_valid_local=None)."""

    def attend(q, k_local, v_local, reference_point, key_xyz_local,
               key_valid_local=None):
        bias = rpe_bias_fn(reference_point, key_xyz_local)
        return sharded_softmax_attention(q, k_local, v_local, bias,
                                         key_valid_local, group)

    return attend
