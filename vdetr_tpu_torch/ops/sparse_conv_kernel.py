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
gather rows; the Hopper kernels gather `feats[nbr[k, v]]` directly.

Each kernel has two forms, picked by the dtype of the features: float32
(split TF32 on the tensor cores, three products per f32 product), and
bf16 (`compute_dtype="bfloat16"`, as the TPU kernels feed the MXU):
features and weights read as bf16, summed in float32, both on `wgmma`
behind an mbarrier ring (`csrc/sparse_conv_sm90.cuh`); the bf16 weight
gradient takes float32 dout as its two bf16 halves (the JAX package
multiplies the f32 cotangent by the bf16 features), split once a 64-hit
stage by the block's producer warpgroup. Both bf16 bodies are bound by
their gathers' latency and L2 traffic, not by the tensor cores. The plain
version of a bf16 form is the float32 one on the bf16 values: their
products are exact in float32, so the two differ only in the order of the
sums. What bounds each kernel on the H100, and how its design answers
it, is in the source notes of `csrc/mapped_conv.cu`,
`csrc/mapped_conv_dw.cu` and `csrc/keyed_conv_dw.cu`.
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


def pad_channels(feats, weights=None):
    """feats (B, V, C) and weights (K, C, Co) with C zero-padded to a
    multiple of 8: the bf16 forms read rows in 16-byte pieces (the stem's
    3 channels become 8). Unchanged where C is one already."""
    C = feats.shape[-1]
    pad = -C % 8
    if pad:
        feats = torch.nn.functional.pad(feats, (0, pad))
        if weights is not None:
            weights = torch.nn.functional.pad(weights, (0, 0, 0, pad))
    return feats, weights


def conv_form(feats, weights=None) -> bool:
    """Whether a conv kernel takes its bf16 form: by the features' dtype
    (float32 or bfloat16); the weights must be of the same dtype. Raises
    otherwise: no input falls back to another form."""
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feats: float32 or bfloat16, got {feats.dtype}")
    if weights is not None and weights.dtype != feats.dtype:
        raise ValueError(f"weights {weights.dtype} with feats {feats.dtype}")
    return feats.dtype == torch.bfloat16


def mapped_conv_plain(feats, nbr, weights):
    """Plain version: per offset, a row gather and a matmul, summed in
    float32 (bf16 operands as the float32 numbers they are)."""
    feats, weights = feats.float(), weights.float()
    idx = nbr.long()
    out = feats.new_zeros(nbr.shape[:1] + nbr.shape[2:] + weights.shape[-1:],
                          dtype=torch.float32)
    for k in range(weights.shape[0]):
        out = out + torch.matmul(gather_rows(feats, idx[:, k]), weights[k])
    return out


def mapped_conv(feats, nbr, weights):
    """Sparse 3^3 conv of `feats` over the neighbour map `nbr`.

    feats (B, V_in, C) float32 or bfloat16; nbr (B, 27, V) int32 rows
    into feats, V_in for a miss (`ops/map_kernel.kernel_map`); weights
    (27, C, Co) of feats' dtype. Returns (B, V, Co) float32; a row whose
    27 entries all miss (an invalid query row) is 0.

    CUDA tensors launch the Hopper kernel (or raise): bf16 features its
    bf16 form (`mapped_conv_bf16`); CPU tensors take
    `mapped_conv_plain`."""
    if not feats.is_cuda:
        return mapped_conv_plain(feats, nbr, weights)
    if conv_form(feats, weights):
        return mapped_conv_bf16(feats, nbr, weights)
    out = _mapped_conv_launch("mapped_conv", feats, nbr, weights)
    mapped_conv.launches += 1
    return out


mapped_conv.launches = 0


def mapped_conv_bf16(feats, nbr, weights):
    """The bf16 form of `mapped_conv`: feats (B, V_in, C) and weights
    (27, C, Co) bfloat16, Co a multiple of 8; (B, V, Co) float32, bf16
    products summed in float32. CPU tensors take `mapped_conv_plain`.

    Its Hopper kernel is `keyed_conv_bf16`'s body over the map
    (`csrc/sparse_conv_sm90.cuh`: `wgmma` behind an mbarrier ring, bound
    by each stage's gather latency, not by the tensor cores), so the two
    are bit-equal; it reads the map's columns where A searches."""
    if not feats.is_cuda:
        return mapped_conv_plain(feats, nbr, weights)
    feats, weights = pad_channels(feats, weights)
    out = _mapped_conv_launch("mapped_conv_bf16", feats, nbr, weights)
    mapped_conv_bf16.launches += 1
    return out


mapped_conv_bf16.launches = 0


def _mapped_conv_launch(name, feats, nbr, weights):
    B, V_in, C = feats.shape
    V = nbr.shape[-1]
    Co = weights.shape[-1]
    _check_common(feats, nbr)
    kernels.check(weights, feats.dtype, (27, C, Co), "weights")
    if feats.dtype == torch.bfloat16 and Co % 8:
        raise ValueError(f"the bf16 form needs Co % 8 == 0, got {Co}")
    dev = feats.device
    out = torch.empty(B, V, Co, dtype=torch.float32, device=dev)
    bf16 = feats.dtype == torch.bfloat16
    splits = conv_splits(C, bf16)
    scratch = conv_scratch(splits, B, V, Co, bf16, dev) if splits > 1 else out
    kernels.call(name, feats.data_ptr(), nbr.data_ptr(),
                 weights.data_ptr(), out.data_ptr(), scratch.data_ptr(), B,
                 V_in, V, C, Co, splits,
                 torch.cuda.current_stream(dev).cuda_stream)
    return out


def conv_scratch(splits: int, B: int, V: int, Co: int, bf16: bool, device):
    """Scratch of an A or H launch whose offsets are split over `splits`
    blocks: the (splits, B, V, Co) f32 partials and, in the bf16 form,
    each split's live flag per 64-row tile (splits, B, ceil(V / 64)) int32
    after them (a tile with no hit in a split leaves its partial
    unwritten)."""
    n = splits * B * V * Co + (splits * B * -(-V // 64) if bf16 else 0)
    return torch.empty(n, dtype=torch.float32, device=device)


def conv_splits(C: int, bf16: bool = False) -> int:
    """Blocks that share each 64-row tile's 27 offsets in kernels A and H
    (their partial sums added in a fixed order): the wider the input, the
    deeper the level and the fewer its live row tiles, and the longer each
    tile's loop over (offset, channel chunk). Per form, since the split
    sets the order of the sums and so the bits: the f32 form's, and the
    bf16 form's (`bf16`, its wgmma body). From a sweep of the published
    convs on the card (`python -m vdetr_tpu_torch.tools.conv_splits`)."""
    if bf16:
        return 1 if C < 256 else 3 if C < 512 else 6
    return 1 if C < 64 else 3 if C < 512 else 6


def mapped_conv_dw_plain(feats, nbr, dout):
    """Plain version of the weight gradient: per offset, the gathered
    input rows (zero at misses) times dout, in float32."""
    feats = feats.float()
    C, Co = feats.shape[-1], dout.shape[-1]
    idx = nbr.long()
    d = dout.reshape(-1, Co)
    return torch.stack([
        torch.matmul(gather_rows(feats, idx[:, k]).reshape(-1, C).t(), d)
        for k in range(27)])


def mapped_conv_dw(feats, nbr, dout):
    """Weight gradient of `mapped_conv`: (27, C, Co) float32 from feats
    (B, V_in, C) float32 or bfloat16 (its bf16 form,
    `mapped_conv_dw_bf16`), the map nbr (B, 27, V) and dout (B, V, Co)
    float32. Rows that miss contribute nothing, so dout needs no masking.

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors take
    `mapped_conv_dw_plain`."""
    if not feats.is_cuda:
        return mapped_conv_dw_plain(feats, nbr, dout)
    if conv_form(feats):
        return mapped_conv_dw_bf16(feats, nbr, dout)
    dw = _mapped_conv_dw_launch("mapped_conv_dw", feats, nbr, dout)
    mapped_conv_dw.launches += 1
    return dw


mapped_conv_dw.launches = 0


def mapped_conv_dw_bf16(feats, nbr, dout):
    """The bf16 form of `mapped_conv_dw`: feats bfloat16, dout float32
    (Co a multiple of 4); (27, C, Co) float32, each product two bf16
    products (dout's bf16 high and low halves), summed in float32. Its
    Hopper kernel is `keyed_conv_dw_bf16`'s `wgmma` body over the map, so
    the two are bit-equal. CPU tensors take `mapped_conv_dw_plain`."""
    if not feats.is_cuda:
        return mapped_conv_dw_plain(feats, nbr, dout)
    C = feats.shape[-1]
    dw = _mapped_conv_dw_launch("mapped_conv_dw_bf16",
                                pad_channels(feats)[0], nbr, dout)
    mapped_conv_dw_bf16.launches += 1
    return dw[:, :C].contiguous() if dw.shape[1] != C else dw


mapped_conv_dw_bf16.launches = 0


def _mapped_conv_dw_launch(name, feats, nbr, dout):
    B, V_in, C = feats.shape
    V, Co = nbr.shape[-1], dout.shape[-1]
    _check_common(feats, nbr)
    kernels.check(dout, torch.float32, (B, V, Co), "dout")
    bf16 = feats.dtype == torch.bfloat16
    splits, rows_per_split = dw_row_splits(B * V, C, Co, bf16=bf16)
    dev = feats.device
    dw = torch.empty(27, C, Co, dtype=torch.float32, device=dev)
    # the partials (from a multiple of 4 floats), then the rulebook
    part = -(-splits * 27 * C * Co // 4) * 4 if splits > 1 else 0
    rulebook = (0 if dw_dense(C, bf16)
                else dw_rulebook_ints(splits, rows_per_split))
    scratch = (torch.empty(part + rulebook, dtype=torch.float32, device=dev)
               if part + rulebook > 0 else dw)
    kernels.call(name, feats.data_ptr(), nbr.data_ptr(),
                 dout.data_ptr(), dw.data_ptr(), scratch.data_ptr(), B, V_in,
                 V, C, Co, splits, rows_per_split,
                 torch.cuda.current_stream(dev).cuda_stream)
    return dw


def dw_dense(C: int, bf16: bool = False) -> bool:
    """Whether kernels D and I take their dense form, a block taking all 27
    offsets of its rows and dW one (27 C, Co) matrix (no rulebook): in the
    f32 form where 27 C fits one 96-row tile (`dw_dense` in
    `csrc/sparse_conv.cuh`: the stem's 3 channels), in the bf16 form at 8
    channels (the stem's 3 padded; `sparse_conv_sm90::dw_dense`: 216 rows
    in four 64-row tiles). Otherwise a block takes one offset's hits from
    the rulebook (`dw_rulebook`)."""
    return C == 8 if bf16 else 27 * C <= 96


def dw_tiles(C: int, Co: int, bf16: bool = False) -> int:
    """Blocks of one row split of a weight-gradient launch: its dW tiles.
    f32: 64 output channels of the dense (27 C, Co) matrix, else an
    offset's 64 x 64 tile. bf16 (`launch_dw_bf16` in
    `csrc/sparse_conv_sm90.cuh`): 64 output channels of the dense (216,
    Co) matrix, else an offset's 128 x 128 tile where C and Co both
    exceed 64, 64 x 64 otherwise."""
    if dw_dense(C, bf16):
        return -(-Co // 64)
    t = 128 if bf16 and C > 64 and Co > 64 else 64
    return 27 * -(-C // t) * -(-Co // t)


def dw_blocks_per_sm(C: int, Co: int, bf16: bool = False) -> int:
    """Blocks of a weight-gradient launch an SM holds: four of the f32
    form's 128 threads; two of the bf16 form's 64 x 64 tiles, one of its
    128 x 128 or dense ones (`dw_bf16_kernel`'s registers and shared
    memory)."""
    if not bf16:
        return 4
    return 1 if dw_dense(C, bf16) or (C > 64 and Co > 64) else 2


# the row-split plans (rounds of resident blocks, min_rows) of each form,
# from `python -m vdetr_tpu_torch.tools.conv_splits --only dw,dw_bf16`
DW_PLAN = {False: (2, 256), True: (3, 512)}


def dw_row_splits(rows: int, C: int, Co: int, waves: int = None,
                  min_rows: int = None, bf16: bool = False):
    """(splits, rows_per_split) of a weight-gradient launch: one block per
    dW tile (`dw_tiles`) and row split; the rows are split over more
    blocks until `waves` rounds of the blocks the card holds at once
    (`dw_blocks_per_sm` x its SMs) have work, each split at least
    `min_rows` rows and a multiple of 32 (partials added in a fixed
    order). The plan is per form (`DW_PLAN`), since the split sets the
    order of the sums and so the bits: f32 (2, 256), two rounds of four
    resident blocks an SM; bf16 (3, 512). From a sweep of the published
    convs on the card (`python -m vdetr_tpu_torch.tools.conv_splits`)."""
    waves = DW_PLAN[bf16][0] if waves is None else waves
    min_rows = DW_PLAN[bf16][1] if min_rows is None else min_rows
    tiles = dw_tiles(C, Co, bf16)
    slots = waves * dw_blocks_per_sm(C, Co, bf16) * _SMS
    splits = max(1, min(-(-slots // tiles), -(-rows // min_rows)))
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
    kernels.check(feats, feats.dtype, (B, V_in, C), "feats")
    kernels.check(nbr, torch.int32, (B, 27, nbr.shape[-1]), "nbr")


class _MappedConv(torch.autograd.Function):
    """`mapped_conv` with its gradients (module docstring): the
    counterpart of `window_conv_ad` (submanifold) and `window_conv_fwdk`
    (stride 2). Under bf16 (the JAX package's dtypes, `_gather_matmul`'s
    vjp): dFeats is the float32 cotangent times the bf16 weights, on the
    float32 form, rounded to bf16; dW is the bf16 form's float32 sum
    rounded to bf16."""

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
                dfeats = mapped_conv(dout, nbr,
                                     flip_weights(weights.float()))
            else:
                dfeats = mapped_conv_dfeats_scatter(
                    dout, nbr, weights.float(), feats.shape[1])
            dfeats = dfeats.to(feats.dtype)
        if ctx.needs_input_grad[1]:
            dw = mapped_conv_dw(feats, nbr, dout).to(weights.dtype)
        return dfeats, dw, None, None


def mapped_conv_ad(feats, nbr, weights, submanifold: bool):
    """Differentiable `mapped_conv` (same arguments). `submanifold` says
    that the map's queries are the table's own sites, which selects the
    dFeats route."""
    return _MappedConv.apply(feats, weights, nbr, submanifold)
