"""VOC-style AP over 3D boxes (VoteNet protocol): a numpy copy of
`vdetr_tpu/eval/eval_det.py`.

Host-side numpy, exactness-critical (reference utils/eval_det.py). The
per-class loop runs in one process: the reference's worker pool
(utils/eval_det.py:283-292) was slower on the H100 machine's 8-core host
at every worker count: each spawned worker imports torch and is sent its
classes' predictions.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from vdetr_tpu_torch.eval import native
from vdetr_tpu_torch.geometry.iou import box3d_iou_np

SIZE_AREA_RNG = (0.17, 0.44)  # S/M/L volume buckets (utils/eval_det.py:89)


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """Continuous-interpolation VOC AP (reference utils/eval_det.py:23-54)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = prec[rec >= t].max() if (rec >= t).any() else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    changed = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[changed + 1] - mrec[changed]) * mpre[changed + 1]).sum())


def get_iou_obb(bb1, bb2) -> float:
    iou3d, _ = box3d_iou_np(bb1, bb2)
    return iou3d


def _box3d_vol_batch(corners):
    """(n, 8, 3) -> (n,) volumes (reference utils/eval_det.py:62-67)."""
    a = np.sqrt((corners[:, 0, 2] - corners[:, 1, 2]) ** 2)
    b = np.sqrt((corners[:, 1, 0] - corners[:, 2, 0]) ** 2)
    c = np.sqrt((corners[:, 0, 1] - corners[:, 4, 1]) ** 2)
    return a * b * c


def _size_filter(vol: np.ndarray, size: str):
    lo, hi = SIZE_AREA_RNG
    if size == "S":
        return vol < lo
    if size == "M":
        return (vol > lo) & (vol < hi)
    if size == "L":
        return vol > hi
    return np.ones_like(vol, dtype=bool)


def eval_det_cls(pred: Dict, gt: Dict, ovthresh: float = 0.25,
                 use_07_metric: bool = False,
                 get_iou_func: Callable = get_iou_obb, size: str = ""):
    """Single-class PR/AP with greedy matching
    (reference utils/eval_det.py:74-185)."""
    class_recs = {}
    npos = 0
    for img_id in gt:
        bbox = np.array(gt[img_id])
        if len(bbox) > 0 and size != "":
            bbox = bbox[_size_filter(_box3d_vol_batch(bbox), size)]
        class_recs[img_id] = {"bbox": bbox, "det": [False] * len(bbox)}
        npos += len(bbox)
    for img_id in pred:
        if img_id not in class_recs:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    image_ids, confidence, boxes = [], [], []
    for img_id in pred:
        for box, score in pred[img_id]:
            if size != "":
                if not _size_filter(_box3d_vol_batch(box[None]), size)[0]:
                    continue
            image_ids.append(img_id)
            confidence.append(score)
            boxes.append(box)
    confidence = np.array(confidence)
    order = np.argsort(-confidence)
    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)

    # Precompute det x gt IoU matrices per image with the native (C++)
    # rotated-IoU kernel when available (counterpart of the reference's
    # Cython box_intersection fast path, utils/box_util.py:689-700).
    iou_mats = {}
    if get_iou_func is get_iou_obb and nd > 0:
        if native.get_lib() is not None:
            per_img_det = {}
            for pos, img_id in enumerate(image_ids):
                per_img_det.setdefault(img_id, []).append(pos)
            for img_id, positions in per_img_det.items():
                gts = class_recs[img_id]["bbox"]
                if len(gts) == 0:
                    continue
                dets = np.stack([boxes[p] for p in positions])
                mat = native.box3d_iou_pairs(dets, np.asarray(gts))
                iou_mats[img_id] = (
                    {p: i for i, p in enumerate(positions)}, mat
                )

    for rank, d in enumerate(order):
        img_id = image_ids[d]
        rec = class_recs[img_id]
        gts = rec["bbox"].astype(float)
        ovmax, jmax = -np.inf, -1
        if img_id in iou_mats:
            pos_map, mat = iou_mats[img_id]
            row = mat[pos_map[d]]
            jmax = int(np.argmax(row))
            ovmax = float(row[jmax]) if len(row) else -np.inf
        else:
            bb = boxes[d].astype(float)
            for j in range(len(gts)):
                iou = get_iou_func(bb, gts[j])
                if iou > ovmax:
                    ovmax, jmax = iou, j
        if ovmax > ovthresh and not rec["det"][jmax]:
            tp[rank] = 1.0
            rec["det"][jmax] = True
        else:
            fp[rank] = 1.0
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos) if npos > 0 else np.zeros_like(tp)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def _group_by_class(pred_all, gt_all):
    pred, gt = {}, {}
    for img_id, dets in pred_all.items():
        for classname, bbox, score in dets:
            pred.setdefault(classname, {}).setdefault(img_id, []).append(
                (bbox, score)
            )
            gt.setdefault(classname, {}).setdefault(img_id, [])
    for img_id, gts in gt_all.items():
        for classname, bbox in gts:
            gt.setdefault(classname, {}).setdefault(img_id, []).append(bbox)
    return pred, gt


def eval_det(pred_all, gt_all, ovthresh=0.25, use_07_metric=False,
             get_iou_func=get_iou_obb, size=""):
    pred, gt = _group_by_class(pred_all, gt_all)
    rec, prec, ap = {}, {}, {}
    for classname in gt:
        if classname in pred:
            rec[classname], prec[classname], ap[classname] = eval_det_cls(
                pred[classname], gt[classname], ovthresh, use_07_metric,
                get_iou_func, size,
            )
        else:
            rec[classname], prec[classname], ap[classname] = 0, 0, 0
    return rec, prec, ap
