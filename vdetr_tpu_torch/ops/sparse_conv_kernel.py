"""3x3x3 sparse convolution over a given neighbour map and its gradients:
the wrappers of the Hopper kernels `csrc/mapped_conv.cu` (forward) and
`csrc/mapped_conv_dw.cu` (weight gradient), their plain PyTorch versions,
and the autograd Function that joins them.

Replaces the TPU kernels `vdetr_tpu/ops/sparse_conv_kernel.py:window_conv`
and `window_conv_dw`. The function, per query row v and offset k:
accumulate `feats[nbr[k, v]] @ W[k]` in float32, a miss (`nbr == V_in`)
contributing 0; its contract in the JAX package is
`sparse_conv._gather_matmul`, and the gradients are that function's vjp
(`window_conv_ad` / `window_conv_fwdk`):
- dW[k] = sum_v feats[nbr[k, v]]^T dout[v]: kernel I;
- dFeats of a submanifold conv (query sites = table sites) is the same
  conv of dout with flipped weights over the same map, since the map is
  exact: nbr[26 - k, m] == n iff nbr[k, n] == m. The TPU path's fix-up
  mirror has no counterpart;
- dFeats of a stride-2 conv is the transpose scatter over the saved map,
  plain torch on every device, as XLA computes it in `_wcf_bwd`.

The TPU kernels consume the map as window anchors, `le` indices and
one-hot selection matmuls (`build_window_map`), because Mosaic cannot
gather rows; the Hopper kernels gather `feats[nbr[k, v]]` directly. The
TPU kernels feed bf16 to the MXU; these stay float32, as the port runs
float32 (`compute_dtype="bfloat16"` is not ported). What bounds each
kernel on the H100, and how its design answers it, is in the source
notes of `csrc/mapped_conv.cu` and `csrc/mapped_conv_dw.cu`.
"""

from __future__ import annotations

import torch

from vdetr_tpu_torch import kernels
from vdetr_tpu_torch.ops.voxelize import gather_rows

_SMS = 132  # streaming multiprocessors of an H100


def flip_weights(weights):
    """Weights of the transpose (gradient) submanifold conv: offset k maps
    to -offset, index 26 - k; input and output channels swap."""
    return weights.flip(0).transpose(1, 2).contiguous()


def mapped_conv_plain(feats, nbr, weights):
    """Plain version: per offset, a row gather and a matmul, summed in
    float32."""
    idx = nbr.long()
    out = feats.new_zeros(nbr.shape[:1] + nbr.shape[2:] + weights.shape[-1:],
                          dtype=torch.float32)
    for k in range(weights.shape[0]):
        out = out + torch.matmul(gather_rows(feats, idx[:, k]), weights[k])
    return out


def mapped_conv(feats, nbr, weights):
    """Sparse 3^3 conv of `feats` over the neighbour map `nbr`.

    feats (B, V_in, C) float32; nbr (B, 27, V) int32 rows into feats, V_in
    for a miss (`ops/map_kernel.kernel_map`); weights (27, C, Co) float32.
    Returns (B, V, Co) float32; a row whose 27 entries all miss (an
    invalid query row) is 0.

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors take
    `mapped_conv_plain`."""
    if not feats.is_cuda:
        return mapped_conv_plain(feats, nbr, weights)
    B, V_in, C = feats.shape
    V = nbr.shape[-1]
    Co = weights.shape[-1]
    _check_common(feats, nbr)
    kernels.check(weights, torch.float32, (27, C, Co), "weights")
    dev = feats.device
    out = torch.empty(B, V, Co, dtype=torch.float32, device=dev)
    splits = conv_splits(C)
    scratch = (torch.empty(splits, B, V, Co, dtype=torch.float32, device=dev)
               if splits > 1 else out)
    kernels.call("mapped_conv", feats.data_ptr(), nbr.data_ptr(),
                 weights.data_ptr(), out.data_ptr(), scratch.data_ptr(), B,
                 V_in, V, C, Co, splits,
                 torch.cuda.current_stream(dev).cuda_stream)
    mapped_conv.launches += 1
    return out


mapped_conv.launches = 0


def conv_splits(C: int) -> int:
    """Blocks that share each 64-row tile's 27 offsets in kernels A and H
    (their partial sums added in a fixed order): the wider the input, the
    deeper the level and the fewer its live row tiles, and the longer each
    tile's (offset, 16-channel) loop. From a sweep of the published convs
    on the card (`python -m vdetr_tpu_torch.tools.conv_splits`)."""
    return 1 if C < 64 else 3 if C < 512 else 6


def mapped_conv_dw_plain(feats, nbr, dout):
    """Plain version of the weight gradient: per offset, the gathered
    input rows (zero at misses) times dout."""
    C, Co = feats.shape[-1], dout.shape[-1]
    idx = nbr.long()
    d = dout.reshape(-1, Co)
    return torch.stack([
        torch.matmul(gather_rows(feats, idx[:, k]).reshape(-1, C).t(), d)
        for k in range(27)])


def mapped_conv_dw(feats, nbr, dout):
    """Weight gradient of `mapped_conv`: (27, C, Co) float32 from feats
    (B, V_in, C), the map nbr (B, 27, V) and dout (B, V, Co). Rows that
    miss contribute nothing, so dout needs no masking.

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors take
    `mapped_conv_dw_plain`."""
    if not feats.is_cuda:
        return mapped_conv_dw_plain(feats, nbr, dout)
    B, V_in, C = feats.shape
    V, Co = nbr.shape[-1], dout.shape[-1]
    _check_common(feats, nbr)
    kernels.check(dout, torch.float32, (B, V, Co), "dout")
    splits, rows_per_split = dw_row_splits(B * V, C, Co)
    dev = feats.device
    dw = torch.empty(27, C, Co, dtype=torch.float32, device=dev)
    # the partials (from a multiple of 4 floats), then the rulebook
    part = -(-splits * 27 * C * Co // 4) * 4 if splits > 1 else 0
    rulebook = 0 if dw_dense(C) else dw_rulebook_ints(splits, rows_per_split)
    scratch = (torch.empty(part + rulebook, dtype=torch.float32, device=dev)
               if part + rulebook > 0 else dw)
    kernels.call("mapped_conv_dw", feats.data_ptr(), nbr.data_ptr(),
                 dout.data_ptr(), dw.data_ptr(), scratch.data_ptr(), B, V_in,
                 V, C, Co, splits, rows_per_split,
                 torch.cuda.current_stream(dev).cuda_stream)
    mapped_conv_dw.launches += 1
    return dw


mapped_conv_dw.launches = 0


def dw_dense(C: int) -> bool:
    """Whether kernels D and I take their dense form (`dw_dense` in
    `csrc/sparse_conv.cuh`): 27 C fits one 96-row tile (the stem's 3
    channels), so a block takes all 27 offsets of its rows and dW is one
    (27 C, Co) matrix; otherwise a block takes one offset's hits from the
    rulebook (`dw_rulebook`)."""
    return 27 * C <= 96


def dw_row_splits(rows: int, C: int, Co: int, waves: int = 8,
                  min_rows: int = 256):
    """(splits, rows_per_split) of a weight-gradient launch: one block per
    dW tile (dense form: 64 output channels of the (27 C, Co) matrix;
    else an offset's 64 x 64 tile) and row split; the rows are split over
    more blocks until `waves` x the card's SMs have work (8: two rounds
    of four resident blocks an SM), each split at least `min_rows` rows
    and a multiple of 32 (partials added in a fixed order). From a sweep
    of the published convs on the card (`python -m
    vdetr_tpu_torch.tools.conv_splits`)."""
    tiles = -(-Co // 64) * (1 if dw_dense(C) else 27 * -(-C // 64))
    splits = max(1, min(-(-waves * _SMS // tiles), -(-rows // min_rows)))
    rows_per_split = max(32, -(-rows // (splits * 32)) * 32)
    return max(1, -(-rows // rows_per_split)), rows_per_split


def dw_rulebook_ints(splits: int, rows_per_split: int) -> int:
    """int32 entries of a rulebook: src and row, (27, splits,
    rows_per_split) each, then count (27, splits)."""
    return 27 * splits * (2 * rows_per_split + 1)


def dw_rulebook(nbr, v_in: int, splits: int, rows_per_split: int):
    """Plain version of the rulebook that kernels D and I build in their
    per-offset form (`dw_rulebook_kernel`): for each offset k and row
    split s, the pairs (input row, query row) of the map's hits, ascending
    in the query row. Rows are global: query row b * V + v, input row
    b * V_in + nbr[b, k, v]. nbr (B, 27, V), V_in or any row outside
    [0, V_in) for a miss. Returns (src, row, count): src and row (27,
    splits, rows_per_split) int32, -1 past the count (the kernel leaves
    those entries unwritten); count (27, splits) int32."""
    B, K, V = nbr.shape
    rows, cap = B * V, splits * rows_per_split
    if cap < rows:
        raise ValueError(f"{splits} splits of {rows_per_split} rows hold "
                         f"fewer than {rows} rows")
    idx = nbr.long().transpose(0, 1)                            # (27, B, V)
    hit = ((idx >= 0) & (idx < v_in)).reshape(K, rows)
    src = (idx + torch.arange(B, device=nbr.device)[:, None] * v_in
           ).reshape(K, rows)
    pad = (0, cap - rows)
    hit = torch.nn.functional.pad(hit, pad).reshape(K, splits, -1)
    src = torch.nn.functional.pad(src, pad).reshape(K, splits, -1)
    row = torch.arange(cap, device=nbr.device).reshape(splits, -1).expand(
        K, -1, -1)
    # a stable sort puts each segment's hits first, in row order
    order = torch.sort((~hit).to(torch.uint8), dim=-1, stable=True).indices
    first = hit.gather(-1, order)
    src = torch.where(first, src.gather(-1, order), -1).to(torch.int32)
    row = torch.where(first, row.gather(-1, order), -1).to(torch.int32)
    return src, row, hit.sum(-1).to(torch.int32)


def mapped_conv_dfeats_scatter(dout, nbr, weights, v_in: int):
    """dFeats of a conv whose query sites are not its table's sites (the
    stride-2 convs): each query row's dout @ W[k]^T added to its k-th
    neighbour's row. Plain torch on every device, as in the JAX package,
    where XLA computes it outside any Pallas kernel."""
    B, V, Co = dout.shape
    C = weights.shape[1]
    idx = nbr.long()
    dfeats = dout.new_zeros(B, v_in + 1, C)  # row v_in takes the misses
    for k in range(27):
        dfeats.scatter_add_(1, idx[:, k, :, None].expand(-1, -1, C),
                            torch.matmul(dout, weights[k].t()))
    return dfeats[:, :v_in]


def _check_common(feats, nbr):
    B, V_in, C = feats.shape
    kernels.check(feats, torch.float32, (B, V_in, C), "feats")
    kernels.check(nbr, torch.int32, (B, 27, nbr.shape[-1]), "nbr")


class _MappedConv(torch.autograd.Function):
    """`mapped_conv` with its gradients (module docstring): the
    counterpart of `window_conv_ad` (submanifold) and `window_conv_fwdk`
    (stride 2)."""

    @staticmethod
    def forward(ctx, feats, weights, nbr, submanifold):
        ctx.save_for_backward(feats, weights, nbr)
        ctx.submanifold = submanifold
        return mapped_conv(feats, nbr, weights)

    @staticmethod
    def backward(ctx, dout):
        feats, weights, nbr = ctx.saved_tensors
        dout = dout.contiguous()
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            if ctx.submanifold:
                dfeats = mapped_conv(dout, nbr, flip_weights(weights))
            else:
                dfeats = mapped_conv_dfeats_scatter(dout, nbr, weights,
                                                    feats.shape[1])
        if ctx.needs_input_grad[1]:
            dw = mapped_conv_dw(feats, nbr, dout)
        return dfeats, dw, None, None


def mapped_conv_ad(feats, nbr, weights, submanifold: bool):
    """Differentiable `mapped_conv` (same arguments). `submanifold` says
    that the map's queries are the table's own sites, which selects the
    dFeats route."""
    return _MappedConv.apply(feats, weights, nbr, submanifold)
