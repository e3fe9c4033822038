"""Greedy 3D NMS: the numpy versions the AP evaluator runs on the host (a
copy of `vdetr_tpu/geometry/nms.py`'s numpy half), and the eval step's
device NMS, `nms_3d_samecls_mask`, the wrapper of kernel N
(`csrc/nms.cu`) beside its plain PyTorch version.

The numpy versions reproduce the reference pick order bit-for-bit
(utils/nms.py:43-162). `nms_3d_samecls_mask` is the counterpart of the
JAX function of that name: a keep mask over a fixed proposal count, with
the greedy semantics of `nms_3d_faster_samecls_np`. Its plain version
follows the JAX `lax.while_loop` literally (masked argmax, keep,
suppress); on the card kernel N runs the whole loop of each scene in two
launches: an overlap bitmask over the boxes in score order, then a scan
of its words.
"""

from __future__ import annotations

import numpy as np
import torch

from vdetr_tpu_torch import kernels
from vdetr_tpu_torch.eval.native import box3d_iou_pairs
from vdetr_tpu_torch.geometry.iou import box3d_iou_np

# the most boxes a scene may hold on the card: kernel N's scan keeps the
# removed set, a bit a box, in 2 KB of shared memory
NMS_MAX_BOXES = 16 * 1024


def nms_2d_faster_np(boxes, overlap_threshold, old_type=False):
    """boxes (n, 5): x1,y1,x2,y2,score. Reference: utils/nms.py:43-77."""
    x1, y1, x2, y2, score = (boxes[:, i] for i in range(5))
    area = (x2 - x1) * (y2 - y1)
    order = np.argsort(score)
    pick = []
    while order.size:
        i = order[-1]
        pick.append(i)
        rest = order[:-1]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        w = np.maximum(0, xx2 - xx1)
        h = np.maximum(0, yy2 - yy1)
        inter = w * h
        denom = area[rest] if old_type else area[i] + area[rest] - inter
        # zero-volume (padded) boxes: the reference's 0/0 NaN compares
        # False and keeps the box; +inf reproduces that without the
        # RuntimeWarning (utils/nms.py has the same degenerate case)
        o = np.where(denom > 0, inter / np.where(denom > 0, denom, 1.0),
                     np.inf)
        order = rest[o <= overlap_threshold]
    return pick


def _nms3d_overlaps(boxes, i, rest, old_type):
    x1, y1, z1, x2, y2, z2 = (boxes[:, k] for k in range(6))
    area = (x2 - x1) * (y2 - y1) * (z2 - z1)
    xx1 = np.maximum(x1[i], x1[rest])
    yy1 = np.maximum(y1[i], y1[rest])
    zz1 = np.maximum(z1[i], z1[rest])
    xx2 = np.minimum(x2[i], x2[rest])
    yy2 = np.minimum(y2[i], y2[rest])
    zz2 = np.minimum(z2[i], z2[rest])
    l = np.maximum(0, xx2 - xx1)
    w = np.maximum(0, yy2 - yy1)
    h = np.maximum(0, zz2 - zz1)
    inter = l * w * h
    denom = area[rest] if old_type else area[i] + area[rest] - inter
    # zero-volume (padded) boxes: the reference's 0/0 NaN compares False
    # and keeps the box; +inf reproduces that without the RuntimeWarning
    return np.where(denom > 0, inter / np.where(denom > 0, denom, 1.0),
                    np.inf)


def nms_3d_faster_np(boxes, overlap_threshold, old_type=False):
    """boxes (n, 7): x1..z2,score. Reference: utils/nms.py:80-117."""
    score = boxes[:, 6]
    order = np.argsort(score)
    pick = []
    while order.size:
        i = order[-1]
        pick.append(i)
        rest = order[:-1]
        o = _nms3d_overlaps(boxes, i, rest, old_type)
        order = rest[o <= overlap_threshold]
    return pick


def nms_3d_faster_samecls_np(boxes, overlap_threshold, old_type=False):
    """boxes (n, 8): x1..z2,score,cls. Reference: utils/nms.py:120-162."""
    score = boxes[:, 6]
    cls = boxes[:, 7]
    order = np.argsort(score)
    pick = []
    while order.size:
        i = order[-1]
        pick.append(i)
        rest = order[:-1]
        o = _nms3d_overlaps(boxes, i, rest, old_type)
        o = o * (cls[i] == cls[rest])
        order = rest[o <= overlap_threshold]
    return pick


def nms_3d_rotated_samecls_np(corners, scores, classes, overlap_threshold):
    """Class-aware greedy NMS with exact rotated 3D IoU.

    corners (n, 8, 3); scores (n,); classes (n,). Same greedy pick order as
    nms_3d_faster_samecls_np but overlaps are true oriented-box IoUs instead
    of axis-aligned-bound IoUs. The reference's --rotated_nms flag selects a
    debug stub that prints corners and crashes (utils/ap_calculator.py:113-114
    leaves pred_mask unbound); this is the working equivalent.
    """
    n = len(scores)
    mat = box3d_iou_pairs(corners, corners)
    if mat is None:
        mat = np.zeros((n, n), np.float32)
        for i in range(n):
            for j in range(i + 1, n):
                mat[i, j] = mat[j, i] = box3d_iou_np(corners[i], corners[j])[0]
    order = np.argsort(scores)
    pick = []
    while order.size:
        i = order[-1]
        pick.append(i)
        rest = order[:-1]
        o = mat[i, rest] * (classes[i] == classes[rest])
        order = rest[o <= overlap_threshold]
    return pick


def overlaps_samecls(aabbs, classes, old_type: bool = False):
    """(B, K, K) overlap ov[b, i, j] of box j against box i, 0 where their
    classes differ: JAX's f32 formula in JAX's order (`area_i + area_j`
    first; `old_type` divides by area_j alone).

    aabbs (B, K, 6) (x1, y1, z1, x2, y2, z2); classes (B, K)."""
    x1, y1, z1, x2, y2, z2 = aabbs.unbind(-1)
    area = (x2 - x1) * (y2 - y1) * (z2 - z1)

    def lo(a):
        return torch.maximum(a[:, :, None], a[:, None, :])

    def hi(a):
        return torch.minimum(a[:, :, None], a[:, None, :])

    inter = ((hi(x2) - lo(x1)).clamp(min=0.0)
             * (hi(y2) - lo(y1)).clamp(min=0.0)
             * (hi(z2) - lo(z1)).clamp(min=0.0))
    if old_type:
        # asymmetric: overlap of candidate-i against remaining-j uses area[j]
        ov = inter / area[:, None, :].clamp(min=1e-12)
    else:
        ov = inter / (area[:, :, None] + area[:, None, :]
                      - inter).clamp(min=1e-12)
    same_cls = classes[:, :, None] == classes[:, None, :]
    return torch.where(same_cls, ov, torch.zeros((), dtype=ov.dtype,
                                                 device=ov.device))


def nms_3d_samecls_mask_plain(aabbs, scores, classes, valid, iou_threshold,
                              old_type: bool = False):
    """Plain version: the JAX `lax.while_loop` of each scene, literally.
    While a box is alive: take the alive box of the largest score (argmax:
    the lowest index among equal scores), keep it, and kill it and every
    box whose same-class overlap with it is > iou_threshold."""
    ov = overlaps_samecls(aabbs, classes, old_type)
    B, K = scores.shape
    keep = torch.zeros(B, K, dtype=torch.bool, device=scores.device)
    ar = torch.arange(K, device=scores.device)
    neg_inf = torch.tensor(-torch.inf, dtype=scores.dtype,
                           device=scores.device)
    for b in range(B):
        alive = valid[b].clone()
        while bool(alive.any()):
            i = torch.where(alive, scores[b], neg_inf).argmax()
            keep[b, i] = True
            alive &= ~((ov[b, i] > iou_threshold) | (ar == i))
    return keep


def nms_launch(aabbs, scores, classes, valid, iou_threshold,
               old_type: bool = False):
    """Launch kernel N on CUDA tensors: aabbs (B, K, 6) float32, scores
    (B, K) float32, classes (B, K) integer, valid (B, K) bool. Returns the
    (B, K) bool keep mask. Counts nothing: `nms_3d_samecls_mask` is the
    main path's entry.

    The kernel works on positions in the order of a stable descending
    sort of the scores (the lowest index first among equal scores), which
    is the order the loop's argmax takes the boxes in: a box the loop
    picks is the first alive box of that order. Its scratch, the (B, K,
    ceil(K / 64)) overlap bitmask and the (B, ceil(K / 64)) seed words of
    the removed set, is allocated here. The loop's one other case, every
    alive score -inf (argmax then returns index 0, alive or not), cannot
    occur: the eval step's scores are probabilities in [0, 1]."""
    B, K = scores.shape
    kernels.check(aabbs, torch.float32, (B, K, 6), "aabbs")
    kernels.check(scores, torch.float32, (B, K), "scores")
    kernels.check(valid, torch.bool, (B, K), "valid")
    if K > NMS_MAX_BOXES:
        raise ValueError(f"kernel N takes at most {NMS_MAX_BOXES} boxes a "
                         f"scene, got {K}")
    order = torch.sort(scores, dim=1, descending=True,
                       stable=True).indices.to(torch.int32)
    cls = classes.to(torch.int32).contiguous()
    kernels.check(cls, torch.int32, (B, K), "classes")
    words = torch.empty(B * (K + 1) * ((K + 63) // 64), dtype=torch.int64,
                        device=scores.device)
    keep = torch.empty(B, K, dtype=torch.bool, device=scores.device)
    kernels.call("nms", aabbs.data_ptr(), order.data_ptr(), cls.data_ptr(),
                 valid.data_ptr(), words.data_ptr(), keep.data_ptr(), B, K,
                 float(iou_threshold), int(old_type),
                 torch.cuda.current_stream(scores.device).cuda_stream)
    return keep


def nms_3d_samecls_mask(aabbs, scores, classes, valid, iou_threshold,
                        old_type: bool = False):
    """Class-aware greedy 3D NMS of each scene of a batch: aabbs (B, K, 6)
    (x1, y1, z1, x2, y2, z2), scores (B, K), classes (B, K) int, valid
    (B, K) bool -> the (B, K) bool keep mask, with the greedy semantics of
    `nms_3d_faster_samecls_np` (ties broken by the lowest index).

    CUDA tensors launch kernel N, once for the batch (its mask and scan
    kernels; or raise); CPU tensors take the plain loop."""
    if not scores.is_cuda:
        return nms_3d_samecls_mask_plain(aabbs, scores, classes, valid,
                                         iou_threshold, old_type)
    keep = nms_launch(aabbs, scores, classes, valid, iou_threshold,
                      old_type)
    nms_3d_samecls_mask.launches += 1
    return keep


nms_3d_samecls_mask.launches = 0
