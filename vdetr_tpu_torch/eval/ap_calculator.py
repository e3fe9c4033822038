"""VoteNet-protocol AP calculation: a numpy copy of
`vdetr_tpu/eval/ap_calculator.py` (reference utils/ap_calculator.py).

`parse_predictions` consumes the host copies of the eval step's outputs:
optional empty-box removal via points-in-boxes on a 40k random subsample
(the port's eval step does it on the device before the copy, as the
reference does; numpy here), greedy NMS (the numpy versions, bit-matching
the reference pick order, or the keep mask the eval step computed on the
device), then per-class proposal expansion: every surviving box is
emitted once per class with score cls_prob * obj_prob
(utils/ap_calculator.py:240-254). `APCalculator.step` takes the eval
step's device tensors and copies each field to the host once.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from vdetr_tpu_torch.eval import native
from vdetr_tpu_torch.eval.eval_det import eval_det
from vdetr_tpu_torch.geometry.nms import (
    nms_2d_faster_np,
    nms_3d_faster_np,
    nms_3d_faster_samecls_np,
    nms_3d_rotated_samecls_np,
)

# the batch fields `APCalculator.step` reads
AP_TARGET_KEYS = ("point_clouds", "gt_box_corners", "gt_box_sem_cls_label",
                  "gt_box_present", "sample_valid")


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array: one copy."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def get_ap_config_dict(
    dataset_config,
    remove_empty_box=True,
    use_3d_nms=True,
    nms_iou=0.25,
    use_old_type_nms=False,
    cls_nms=True,
    per_class_proposal=True,
    use_cls_confidence_only=False,
    conf_thresh=0.0,
    no_nms=False,
    empty_pt_thre=5,
    angle_nms=False,
    angle_conf=False,
    rotated_nms=False,
):
    return {
        "rotated_nms": rotated_nms,
        "remove_empty_box": remove_empty_box,
        "use_3d_nms": use_3d_nms,
        "nms_iou": nms_iou,
        "use_old_type_nms": use_old_type_nms,
        "cls_nms": cls_nms,
        "per_class_proposal": per_class_proposal,
        "use_cls_confidence_only": use_cls_confidence_only,
        "conf_thresh": conf_thresh,
        "no_nms": no_nms,
        "dataset_config": dataset_config,
        "empty_pt_thre": empty_pt_thre,
        "angle_nms": angle_nms,
        "angle_conf": angle_conf,
    }


def config_dict_from_cfg(cfg, dataset_config):
    """Build the AP config from a VDETRConfig (reference APCalculator
    __init__, utils/ap_calculator.py:344-360)."""
    return get_ap_config_dict(
        dataset_config=dataset_config,
        remove_empty_box=not cfg.test_no_nms and cfg.test_only,
        no_nms=cfg.test_no_nms,
        use_3d_nms=not cfg.no_3d_nms,
        nms_iou=cfg.nms_iou,
        empty_pt_thre=cfg.empty_pt_thre,
        conf_thresh=cfg.conf_thresh,
        angle_nms=cfg.angle_nms,
        angle_conf=cfg.angle_conf,
        use_old_type_nms=cfg.use_old_type_nms,
        cls_nms=not cfg.no_cls_nms,
        per_class_proposal=not cfg.no_per_class_proposal,
        use_cls_confidence_only=cfg.use_cls_confidence_only,
        rotated_nms=cfg.rotated_nms,
    )


def _points_in_boxes_np(points, boxes):
    """points (N, 3); boxes (T, 7) bottom-centered, yaw about z -> (N, T)."""
    d = points[:, None, :] - boxes[None, :, :3]
    c = np.cos(-boxes[:, 6])
    s = np.sin(-boxes[:, 6])
    lx = d[..., 0] * c[None] - d[..., 1] * s[None]
    ly = d[..., 0] * s[None] + d[..., 1] * c[None]
    lz = d[..., 2]
    return (
        (np.abs(lx) < boxes[None, :, 3] / 2)
        & (np.abs(ly) < boxes[None, :, 4] / 2)
        & (lz >= 0)
        & (lz <= boxes[None, :, 5])
    )


def device_nms_variant_ok(config_dict) -> bool:
    """The configured NMS variant is the one `nms_3d_samecls_mask`
    (kernel N) implements on the device (the published eval path:
    class-aware axis-aligned 3D NMS)."""
    return (
        config_dict["use_3d_nms"]
        and config_dict["cls_nms"]
        and not config_dict["use_old_type_nms"]
        and not config_dict["angle_nms"]
        and not config_dict.get("rotated_nms")
        and not config_dict.get("no_nms")
    )


def device_nms_supported(config_dict) -> bool:
    """Variant ok; empty-box removal (when configured) is folded into the
    device mask by the eval step (points-in-boxes counts on a fixed 40k
    subsample, `Trainer.eval_step`)."""
    return device_nms_variant_ok(config_dict)


def parse_predictions(predicted_boxes, sem_cls_probs, objectness_probs,
                      angle_probs, point_cloud, config_dict,
                      predicted_boxes_CSA=None, rng=None,
                      precomputed_nms_mask=None):
    """Reference utils/ap_calculator.py:48-282. All inputs numpy.

    precomputed_nms_mask: (B, K) keep mask already computed on the device
    by the eval step (geometry.nms.nms_3d_samecls_mask, pick-order
    parity-tested vs the numpy path, empty-box removal included); only
    honored when the configured variant matches `device_nms_supported`,
    and then the host's empty-box removal, whose result only the other
    branches read, is skipped."""
    sem_cls_probs = np.asarray(sem_cls_probs)
    pred_sem_cls = np.argmax(sem_cls_probs, -1)
    obj_prob = np.asarray(objectness_probs)
    angle_probs = np.asarray(angle_probs)
    corners = np.asarray(predicted_boxes)
    bsize, K = corners.shape[:2]
    nonempty = np.ones((bsize, K))

    use_mask = (precomputed_nms_mask is not None
                and device_nms_supported(config_dict))
    # the device mask already holds the empty-box removal: the host's
    # (a (40000, K) test a scene in numpy, seconds) would go unread
    if (config_dict["remove_empty_box"] and predicted_boxes_CSA is not None
            and not use_mask):
        csa = np.array(predicted_boxes_CSA, copy=True)
        csa[..., 2] -= csa[..., 5] / 2  # bottom center
        pc = np.asarray(point_cloud)
        rng = rng or np.random.RandomState(0)
        nsub = min(40000, pc.shape[1])
        sel = rng.permutation(pc.shape[1])[:nsub]
        for i in range(bsize):
            inbox = _points_in_boxes_np(pc[i, sel, :3], csa[i])
            cnt = inbox.sum(0)
            nonempty[i] = (cnt >= config_dict["empty_pt_thre"]).astype(float)
            if nonempty[i].sum() == 0:
                nonempty[i, obj_prob[i].argmax()] = 1

    def aabb(i):
        b = np.zeros((K, 6))
        b[:, 0] = corners[i, :, :, 0].min(-1)
        b[:, 1] = corners[i, :, :, 1].min(-1)
        b[:, 2] = corners[i, :, :, 2].min(-1)
        b[:, 3] = corners[i, :, :, 0].max(-1)
        b[:, 4] = corners[i, :, :, 1].max(-1)
        b[:, 5] = corners[i, :, :, 2].max(-1)
        return b

    if use_mask:
        pred_mask = np.asarray(precomputed_nms_mask, dtype=float)
    elif config_dict.get("rotated_nms"):
        # true oriented-box NMS (the reference flag selects a debug stub,
        # utils/ap_calculator.py:113-114; see nms_3d_rotated_samecls_np)
        pred_mask = np.zeros((bsize, K))
        for i in range(bsize):
            keep_ids = np.where(nonempty[i] == 1)[0]
            score = (obj_prob[i] * angle_probs[i]
                     if config_dict["angle_nms"] else obj_prob[i])
            pick = nms_3d_rotated_samecls_np(
                corners[i, keep_ids], score[keep_ids],
                pred_sem_cls[i, keep_ids], config_dict["nms_iou"],
            )
            pred_mask[i, keep_ids[pick]] = 1
    elif config_dict.get("no_nms"):
        pred_mask = nonempty
    elif not config_dict["use_3d_nms"]:
        pred_mask = np.zeros((bsize, K))
        for i in range(bsize):
            b = np.zeros((K, 5))
            b[:, 0] = corners[i, :, :, 0].min(-1)
            b[:, 2] = corners[i, :, :, 0].max(-1)
            b[:, 1] = corners[i, :, :, 2].min(-1)
            b[:, 3] = corners[i, :, :, 2].max(-1)
            b[:, 4] = obj_prob[i]
            keep_ids = np.where(nonempty[i] == 1)[0]
            pick = nms_2d_faster_np(b[keep_ids], config_dict["nms_iou"],
                                    config_dict["use_old_type_nms"])
            pred_mask[i, keep_ids[pick]] = 1
    elif not config_dict["cls_nms"]:
        pred_mask = np.zeros((bsize, K))
        for i in range(bsize):
            b = np.zeros((K, 7))
            b[:, :6] = aabb(i)
            b[:, 6] = obj_prob[i]
            keep_ids = np.where(nonempty[i] == 1)[0]
            pick = nms_3d_faster_np(b[keep_ids], config_dict["nms_iou"],
                                    config_dict["use_old_type_nms"])
            pred_mask[i, keep_ids[pick]] = 1
    else:
        pred_mask = np.zeros((bsize, K))
        for i in range(bsize):
            b = np.zeros((K, 8))
            b[:, :6] = aabb(i)
            b[:, 6] = (obj_prob[i] * angle_probs[i]
                       if config_dict["angle_nms"] else obj_prob[i])
            b[:, 7] = pred_sem_cls[i]
            keep_ids = np.where(nonempty[i] == 1)[0]
            pick = nms_3d_faster_samecls_np(
                b[keep_ids], config_dict["nms_iou"],
                config_dict["use_old_type_nms"],
            )
            pred_mask[i, keep_ids[pick]] = 1

    thresh = config_dict["conf_thresh"]
    num_semcls = config_dict["dataset_config"].num_semcls
    batch_pred = []
    for i in range(bsize):
        if config_dict["angle_conf"] or config_dict["per_class_proposal"]:
            extra = (angle_probs[i] if config_dict["angle_conf"]
                     else np.ones(K))
            cur = []
            for c in range(num_semcls):
                cur += [
                    (c, corners[i, j], sem_cls_probs[i, j, c] * obj_prob[i, j]
                     * extra[j])
                    for j in range(K)
                    if pred_mask[i, j] == 1 and obj_prob[i, j] > thresh
                ]
            batch_pred.append(cur)
        elif config_dict["use_cls_confidence_only"]:
            batch_pred.append([
                (int(pred_sem_cls[i, j]), corners[i, j],
                 sem_cls_probs[i, j, int(pred_sem_cls[i, j])])
                for j in range(K)
                if pred_mask[i, j] == 1 and obj_prob[i, j] > thresh
            ])
        else:
            batch_pred.append([
                (int(pred_sem_cls[i, j]), corners[i, j], obj_prob[i, j])
                for j in range(K)
                if pred_mask[i, j] == 1 and obj_prob[i, j] > thresh
            ])
    return batch_pred


class APCalculator:
    """Reference utils/ap_calculator.py:324-529, with the per-class AP
    in one process (`eval/eval_det.py`), where the reference and the JAX
    package fan it out over 10 workers."""

    def __init__(self, dataset_config, ap_iou_thresh=(0.25, 0.5),
                 class2type_map=None, ap_config_dict=None,
                 axis_align_test: bool = False):
        self.ap_iou_thresh = list(ap_iou_thresh)
        self.ap_config_dict = ap_config_dict or get_ap_config_dict(
            dataset_config=dataset_config
        )
        self.class2type_map = class2type_map
        self.axis_align_test = axis_align_test
        self.reset()

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.scan_cnt = 0

    def make_gt_list(self, gt_box_corners, gt_box_sem_cls_labels,
                     gt_box_present):
        out = []
        for i in range(gt_box_corners.shape[0]):
            out.append([
                (int(gt_box_sem_cls_labels[i, j]), gt_box_corners[i, j])
                for j in range(gt_box_corners.shape[1])
                if gt_box_present[i, j] == 1
            ])
        return out

    def step(self, outputs: Dict, targets: Dict):
        """outputs: eval-step dict (device tensors or numpy); targets:
        batch dict (numpy or tensors). Each field is copied to the host
        once."""
        corners_key = ("box_corners_axis_align" if self.axis_align_test
                       else "box_corners")
        outputs = {k: _host(outputs[k]) for k in (
            corners_key, "sem_cls_prob", "objectness_prob", "angle_prob",
            "center_unnormalized", "size_unnormalized", "angle_continuous",
            "nms_keep") if k in outputs}
        targets = {k: _host(targets[k]) for k in AP_TARGET_KEYS
                   if k in targets}
        csa = np.concatenate(
            [outputs["center_unnormalized"], outputs["size_unnormalized"],
             outputs["angle_continuous"][..., None]], axis=-1,
        )
        batch_pred = parse_predictions(
            outputs[corners_key],
            outputs["sem_cls_prob"],
            outputs["objectness_prob"],
            outputs["angle_prob"],
            targets["point_clouds"],
            self.ap_config_dict,
            predicted_boxes_CSA=csa,
            precomputed_nms_mask=outputs.get("nms_keep"),
        )
        batch_gt = self.make_gt_list(
            targets["gt_box_corners"],
            targets["gt_box_sem_cls_label"],
            targets["gt_box_present"],
        )
        # skip pad samples from a pad_last loader (the reference never pads:
        # it evaluates every scan at bs=1, engine.py:125-192)
        valid = targets.get("sample_valid")
        valid = (valid if valid is not None
                 else np.ones(len(batch_pred), bool))
        for ok, pred, gt in zip(valid, batch_pred, batch_gt):
            if not ok:
                continue
            self.pred_map_cls[self.scan_cnt] = pred
            self.gt_map_cls[self.scan_cnt] = gt
            self.scan_cnt += 1

    def compute_metrics(self, size=""):
        # which rotated IoU scores: the native library, or numpy without
        # a compiler
        self.iou_path = native.iou_path()
        overall = OrderedDict()
        for thresh in self.ap_iou_thresh:
            ret = OrderedDict()
            rec, prec, ap = eval_det(
                self.pred_map_cls, self.gt_map_cls, ovthresh=thresh,
                size=size,
            )
            for key in sorted(ap.keys()):
                name = (self.class2type_map[key] if self.class2type_map
                        else str(key))
                ret[f"{name} Average Precision"] = ap[key]
            vals = np.array(list(ap.values()), dtype=np.float32)
            vals[np.isnan(vals)] = 0
            ret["mAP"] = vals.mean() if len(vals) else 0.0
            rec_list = []
            for key in sorted(ap.keys()):
                name = (self.class2type_map[key] if self.class2type_map
                        else str(key))
                try:
                    ret[f"{name} Recall"] = rec[key][-1]
                    rec_list.append(rec[key][-1])
                except (TypeError, IndexError):
                    ret[f"{name} Recall"] = 0
                    rec_list.append(0)
            ret["AR"] = np.mean(rec_list) if rec_list else 0.0
            overall[thresh] = ret
        return overall

    def metrics_to_str(self, overall, per_class: bool = True) -> str:
        """Reproduces the reference print format
        (utils/ap_calculator.py:480-515, cf. results/scannet_result.txt)."""
        mAPs = [f"{overall[t]['mAP'] * 100:.2f}" for t in self.ap_iou_thresh]
        ARs = [f"{overall[t]['AR'] * 100:.2f}" for t in self.ap_iou_thresh]
        lines = []
        head = ", ".join(f"mAP{t:.2f}" for t in self.ap_iou_thresh)
        out = head + ": " + ", ".join(mAPs) + "\n"
        out += ", ".join(f"AR{t:.2f}" for t in self.ap_iou_thresh)
        out += ": " + ", ".join(ARs)
        if per_class:
            for t in self.ap_iou_thresh:
                lines.append("-" * 5)
                lines.append(f"IOU Thresh={t}")
                for k, v in overall[t].items():
                    if k not in ("mAP", "AR"):
                        lines.append(f"{k}: {v * 100:.2f}")
            out += "\n" + "\n".join(lines)
        return out

    def metrics_to_dict(self, overall) -> Dict[str, float]:
        d = {}
        for t in self.ap_iou_thresh:
            d[f"mAP_{t}"] = overall[t]["mAP"] * 100
            d[f"AR_{t}"] = overall[t]["AR"] * 100
        return d

    def __str__(self):
        return self.metrics_to_str(self.compute_metrics())
