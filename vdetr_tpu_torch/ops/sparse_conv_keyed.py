"""Keyed 3x3x3 sparse convolution and its gradients: the wrappers of the
Hopper kernels `csrc/keyed_conv.cu` (forward) and `csrc/keyed_conv_dw.cu`
(weight gradient), their plain PyTorch versions, and the autograd
Function that joins them.

Replaces the TPU kernels `vdetr_tpu/ops/sparse_conv_keyed.py:keyed_conv`
and `keyed_conv_dw`. The function, per query row v and kernel offset k
(x-major, z-fastest, `kernel_offsets`): pack `q[v] + off[k]` with
`pack_keys`' bounds check, find it in the sorted keys of the input table,
and accumulate `feats[hit] @ W[k]` in float32; a miss contributes 0. Its
contract in the JAX package is `sparse_conv._gather_matmul` over
`_zrun_neighbors`, and the gradients are that function's vjp:
- dW[k] = sum_v feats[nbr_k(v)]^T dout[v]: kernel D;
- dFeats of a submanifold conv (query sites = table sites) is the same
  conv of dout with flipped weights, W'[k] = W[26 - k]^T, since
  nbr_k(v) = u iff nbr_{26-k}(u) = v (the JAX package's identity,
  `_kc_bwd`): kernel A again. The Hopper kernel resolves every neighbour
  exactly, so none of the TPU kernel's fix-up rows are needed;
- dFeats of a stride-2 conv is the transpose scatter (`_kcf_bwd`), which
  the JAX package leaves to XLA: here a lookup, a matmul per offset and a
  scatter-add, in plain torch ops.

Both kernels have a float32 and a bf16 form, picked by the features'
dtype, with the dtype rules of `ops/sparse_conv_kernel.py` (the mapped
route's kernels H and I, whose GEMM bodies A and D share). What bounds
each kernel on the H100, and how its design answers it, is in the source
notes of `csrc/keyed_conv.cu` and `csrc/keyed_conv_dw.cu`.
"""

from __future__ import annotations

import torch

from vdetr_tpu_torch import kernels
from vdetr_tpu_torch.ops.map_kernel import neighbour_map
from vdetr_tpu_torch.ops.sparse_conv_kernel import (
    conv_form, conv_scratch, conv_splits, dw_dense, dw_row_splits,
    dw_rulebook_ints, flip_weights, mapped_conv_dfeats_scatter,
    mapped_conv_dw_plain, mapped_conv_plain, pad_channels)


def keyed_conv_plain(feats, in_keys, q_coords, q_valid, extent, weights):
    """Plain version: the neighbour map by `searchsorted`, then a row
    gather and a matmul per offset, accumulated in float32."""
    return mapped_conv_plain(
        feats, neighbour_map(in_keys, q_coords, q_valid, extent), weights)


def keyed_conv(feats, in_keys, q_coords, q_valid, extent, weights):
    """Sparse 3^3 conv of `feats` at query sites.

    feats (B, V_in, C) float32 or bfloat16; in_keys (B, V_in) int32
    ascending (empty slots KEY_SENTINEL); q_coords (B, V, 3) int32 in the
    input lattice; q_valid (B, V) bool; extent the input lattice's (GX,
    GY, GZ); weights (27, C, Co) of feats' dtype. Returns (B, V, Co)
    float32, zero at invalid query rows.

    CUDA tensors launch the Hopper kernel (or raise): bf16 features its
    bf16 form (`keyed_conv_bf16`); CPU tensors take `keyed_conv_plain`."""
    if not feats.is_cuda:
        return keyed_conv_plain(feats, in_keys, q_coords, q_valid, extent,
                                weights)
    if conv_form(feats, weights):
        return keyed_conv_bf16(feats, in_keys, q_coords, q_valid, extent,
                               weights)
    out = _keyed_conv_launch("keyed_conv", feats, in_keys, q_coords,
                             q_valid, extent, weights)
    keyed_conv.launches += 1
    return out


keyed_conv.launches = 0


def keyed_conv_bf16(feats, in_keys, q_coords, q_valid, extent, weights):
    """The bf16 form of `keyed_conv`: feats and weights bfloat16, Co a
    multiple of 8; bf16 products summed in float32. CPU tensors take
    `keyed_conv_plain`.

    Its Hopper kernel (`csrc/sparse_conv_sm90.cuh`, under
    `csrc/keyed_conv.cu:keyed_conv_bf16`) is bound by latency, not by the
    tensor cores: each 64-channel stage of gathered rows and weights must
    arrive before its four `wgmma` steps can run, and a tile's neighbour
    rows are found by binary search first. It keeps four stages in flight
    behind full/empty mbarriers (the rows by a producer warpgroup's
    `cp.async`, the weights by TMA), computes 128 x 64 or 64 x 128 outputs
    a block so that a tile's rows are resolved once for both halves, finds
    a row's three z-neighbours with one lockstep search, and splits the
    offsets of the deep, sparse levels over blocks whose empty tiles
    write nothing (`conv_splits(C, bf16=True)`)."""
    if not feats.is_cuda:
        return keyed_conv_plain(feats, in_keys, q_coords, q_valid, extent,
                                weights)
    feats, weights = pad_channels(feats, weights)
    out = _keyed_conv_launch("keyed_conv_bf16", feats, in_keys, q_coords,
                             q_valid, extent, weights)
    keyed_conv_bf16.launches += 1
    return out


keyed_conv_bf16.launches = 0


def _keyed_conv_launch(name, feats, in_keys, q_coords, q_valid, extent,
                       weights):
    B, V_in, C = feats.shape
    V = q_coords.shape[1]
    Co = weights.shape[-1]
    gx, gy, gz = _check_common(feats, in_keys, q_coords, q_valid, extent)
    kernels.check(weights, feats.dtype, (27, C, Co), "weights")
    if feats.dtype == torch.bfloat16 and Co % 8:
        raise ValueError(f"the bf16 form needs Co % 8 == 0, got {Co}")
    out = torch.empty(B, V, Co, dtype=torch.float32, device=feats.device)
    bf16 = feats.dtype == torch.bfloat16
    splits = conv_splits(C, bf16)
    scratch = (conv_scratch(splits, B, V, Co, bf16, feats.device)
               if splits > 1 else out)
    kernels.call(name, feats.data_ptr(), in_keys.data_ptr(),
                 q_coords.data_ptr(), q_valid.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), B, V_in, V, C, Co, gx,
                 gy, gz, splits,
                 torch.cuda.current_stream(feats.device).cuda_stream)
    return out


def keyed_conv_dw_plain(feats, in_keys, q_coords, q_valid, extent, dout):
    """Plain version of the weight gradient: per offset, the gathered
    input rows (zero at misses and invalid rows) times dout."""
    return mapped_conv_dw_plain(
        feats, neighbour_map(in_keys, q_coords, q_valid, extent), dout)


def keyed_conv_dw(feats, in_keys, q_coords, q_valid, extent, dout):
    """Weight gradient of `keyed_conv`: (27, C, Co) float32 from feats
    (B, V_in, C) float32 or bfloat16 (its bf16 form, `keyed_conv_dw_bf16`),
    the conv's sites and dout (B, V, Co) float32. Rows that are invalid or
    miss contribute nothing, so dout needs no masking.

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors take
    `keyed_conv_dw_plain`."""
    if not feats.is_cuda:
        return keyed_conv_dw_plain(feats, in_keys, q_coords, q_valid, extent,
                                   dout)
    if conv_form(feats):
        return keyed_conv_dw_bf16(feats, in_keys, q_coords, q_valid, extent,
                                  dout)
    dw = _keyed_conv_dw_launch("keyed_conv_dw", feats, in_keys, q_coords,
                               q_valid, extent, dout)
    keyed_conv_dw.launches += 1
    return dw


keyed_conv_dw.launches = 0


def keyed_conv_dw_bf16(feats, in_keys, q_coords, q_valid, extent, dout):
    """The bf16 form of `keyed_conv_dw`: feats bfloat16, dout float32 (Co
    a multiple of 4); each product two bf16 products (dout's bf16 high
    and low halves), summed in float32. CPU tensors take
    `keyed_conv_dw_plain`.

    Its Hopper kernel (`csrc/sparse_conv_sm90.cuh:dw_bf16_kernel`) is
    bound by its per-hit gathers of feature and f32 dout rows from L2,
    not by the tensor cores: a producer warpgroup keeps 64-hit stages of
    `cp.async` gathers in flight behind an mbarrier ring and splits each
    stage's dout into its bf16 halves once for the block; the consumer
    warpgroups run `wgmma` on both operands from shared memory, in 128 x
    128 tiles where both widths exceed 64 (half the gathers a hit). The
    stem's 8 padded channels take a dense form: every row, its 27
    neighbours as dW's 216 rows, dout read once. Row splits of its own
    (`dw_row_splits(..., bf16=True)`), added in a fixed order."""
    if not feats.is_cuda:
        return keyed_conv_dw_plain(feats, in_keys, q_coords, q_valid, extent,
                                   dout)
    C = feats.shape[-1]
    dw = _keyed_conv_dw_launch("keyed_conv_dw_bf16", pad_channels(feats)[0],
                               in_keys, q_coords, q_valid, extent, dout)
    keyed_conv_dw_bf16.launches += 1
    return dw[:, :C].contiguous() if dw.shape[1] != C else dw


keyed_conv_dw_bf16.launches = 0


def _keyed_conv_dw_launch(name, feats, in_keys, q_coords, q_valid, extent,
                          dout):
    B, V_in, C = feats.shape
    V, Co = q_coords.shape[1], dout.shape[-1]
    gx, gy, gz = _check_common(feats, in_keys, q_coords, q_valid, extent)
    kernels.check(dout, torch.float32, (B, V, Co), "dout")
    rows = B * V
    bf16 = feats.dtype == torch.bfloat16
    splits, rows_per_split = dw_row_splits(rows, C, Co, bf16=bf16)
    dev = feats.device
    dw = torch.empty(27, C, Co, dtype=torch.float32, device=dev)
    # the dense form's (27, rows) map, or the rulebook
    nbr = torch.empty(27 * rows if dw_dense(C, bf16) else
                      dw_rulebook_ints(splits, rows_per_split),
                      dtype=torch.int32, device=dev)
    scratch = (torch.empty(splits, 27, C, Co, dtype=torch.float32,
                           device=dev) if splits > 1 else dw)
    kernels.call(name, feats.data_ptr(), in_keys.data_ptr(),
                 q_coords.data_ptr(), q_valid.data_ptr(), dout.data_ptr(),
                 dw.data_ptr(), nbr.data_ptr(), scratch.data_ptr(), B, V_in,
                 V, C, Co, gx, gy, gz, splits, rows_per_split,
                 torch.cuda.current_stream(dev).cuda_stream)
    return dw


def _check_common(feats, in_keys, q_coords, q_valid, extent):
    B, V_in, C = feats.shape
    V = q_coords.shape[1]
    gx, gy, gz = (int(e) for e in extent)
    kernels.check(feats, feats.dtype, (B, V_in, C), "feats")
    kernels.check(in_keys, torch.int32, (B, V_in), "in_keys")
    kernels.check(q_coords, torch.int32, (B, V, 3), "q_coords")
    kernels.check(q_valid, torch.bool, (B, V), "q_valid")
    if gx * gy * gz > 2 ** 31:  # the largest key must fit in int32
        raise ValueError(f"extent {extent} does not pack into int32 keys")
    return gx, gy, gz


class _KeyedConv(torch.autograd.Function):
    """`keyed_conv` with its gradients (module docstring). Under bf16, as
    the JAX package's `_gather_matmul` vjp: dFeats is the float32
    cotangent times the bf16 weights, on the float32 form, rounded to
    bf16; dW is the bf16 form's float32 sum rounded to bf16."""

    @staticmethod
    def forward(ctx, feats, weights, in_keys, q_coords, q_valid, extent,
                submanifold):
        ctx.save_for_backward(feats, weights, in_keys, q_coords, q_valid)
        ctx.extent = extent
        ctx.submanifold = submanifold
        return keyed_conv(feats, in_keys, q_coords, q_valid, extent, weights)

    @staticmethod
    def backward(ctx, dout):
        feats, weights, in_keys, q_coords, q_valid = ctx.saved_tensors
        dout = dout.contiguous()
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            if ctx.submanifold:
                dfeats = keyed_conv(dout, in_keys, q_coords, q_valid,
                                    ctx.extent, flip_weights(weights.float()))
            else:
                dfeats = mapped_conv_dfeats_scatter(
                    dout, neighbour_map(in_keys, q_coords, q_valid,
                                        ctx.extent), weights.float(),
                    feats.shape[1])
            dfeats = dfeats.to(feats.dtype)
        if ctx.needs_input_grad[1]:
            dw = keyed_conv_dw(feats, in_keys, q_coords, q_valid, ctx.extent,
                               dout).to(weights.dtype)
        return dfeats, dw, None, None, None, None, None


def keyed_conv_ad(feats, in_keys, q_coords, q_valid, extent, weights,
                  submanifold: bool):
    """Differentiable `keyed_conv` (same arguments). `submanifold` says
    that the query sites are the table's own sites (q_coords are its
    coords, q_valid its validity), which selects the dFeats route."""
    return _KeyedConv.apply(feats, weights, in_keys, q_coords, q_valid,
                            extent, submanifold)
