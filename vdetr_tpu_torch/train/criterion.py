"""Set-prediction criterion: matching and the V-DETR losses (torch
counterpart of `vdetr_tpu/train/criterion.py:33-491`; reference
criterion.py).

Per step the criterion builds one matching job per decoder output: the
final layer and the aux layers 1..7 against the ground truth repeated
`repeat_num` times, aux layer 0 (all seeds) against the un-repeated
ground truth with every label 0 when `is_bilable`. The jobs are grouped
by cost shape and repeat, as the JAX criterion groups them, and each
group is solved in one call: under `matcher_impl="auction"` (the
default) by the capacity auction for the repeated jobs and the plain
auction otherwise (`ops/hungarian.py`; kernel M on the card, one launch
a group, no device-to-host copy); under `"jv"` by exact JV on the host,
the costs of all jobs leaving the device in one copy. The assignments
feed the losses: focal classification, angle class and residual, center
L1, GIoU and log-size L1, each normalized by the number of (repeated)
boxes, plus the encoder point-classification loss.

Ported for the published ScanNet model: GIoU of axis-aligned boxes.
Rotated boxes (an angle-binned dataset, `iou_type` diou/iou) are not
ported yet; the criterion refuses them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vdetr_tpu_torch.geometry.iou import generalized_box3d_iou
from vdetr_tpu_torch.geometry.points_in_boxes import points_in_boxes_all
from vdetr_tpu_torch.ops.hungarian import (auction, auction_capacity,
                                           hungarian)

Tensors = Dict[str, torch.Tensor]


def huber_loss(error, delta: float = 1.0):
    """Reference utils/misc.py:25-36."""
    abs_error = error.abs()
    quadratic = torch.clamp(abs_error, max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def sigmoid_focal_loss_sum(logits, targets, alpha: float = 0.25,
                           gamma: float = 2.0):
    """Elementwise focal loss, summed; the caller divides by the number
    of boxes (reference criterion.py:73-98)."""
    prob = torch.sigmoid(logits)
    ce = (torch.clamp(logits, min=0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss.sum()


_GT_KEYS = {
    2: ["gt_box_corners"],
    1: ["gt_box_centers", "gt_box_centers_normalized", "gt_box_sizes",
        "gt_box_sizes_normalized"],
    0: ["gt_box_sem_cls_label", "gt_box_present", "gt_box_angles",
        "gt_angle_class_label", "gt_angle_residual_label"],
}


def repeat_ground_truth(targets: Tensors, repeat: int) -> Tensors:
    """Tile every GT field `repeat` times along the object axis, then
    compact the present entries to the front (reference
    criterion.py:532-618)."""
    out = dict(targets)
    present = targets["gt_box_present"].repeat(1, repeat)   # (B, R*K)
    order = torch.argsort((present <= 0).to(torch.int8), dim=1, stable=True)
    keep = present.gather(1, order) > 0
    for extra, keys in _GT_KEYS.items():
        for k in keys:
            x = targets[k].repeat((1, repeat) + (1,) * extra)
            idx = order.reshape(order.shape + (1,) * extra).expand(x.shape)
            m = keep.reshape(keep.shape + (1,) * extra)
            out[k] = torch.where(m, x.gather(1, idx), torch.zeros_like(x))
    out["nactual_gt"] = targets["nactual_gt"] * repeat
    return out


def _take(x, inds):
    """x (B, K, ...) rows at inds (B, N) -> (B, N, ...)."""
    idx = inds.reshape(inds.shape + (1,) * (x.ndim - 2))
    return x.gather(1, idx.expand(inds.shape + x.shape[2:]))


class SetCriterion:
    """Stateless; construct once per config (reference criterion.py:231)."""

    def __init__(self, cfg, dataset_config):
        if cfg.matcher_impl not in ("auction", "jv"):
            raise ValueError(f"unknown matcher_impl {cfg.matcher_impl!r}")
        if cfg.iou_type != "giou" or dataset_config.num_angle_bin > 1:
            raise NotImplementedError(
                "only the axis-aligned GIoU path is ported (ScanNet)")
        self.cfg = cfg
        self.ds = dataset_config
        self.loss_weights = {
            "loss_giou": cfg.loss_giou_weight,
            "loss_sem_cls": cfg.loss_sem_cls_weight,
            "loss_angle_cls": cfg.loss_angle_cls_weight,
            "loss_angle_reg": cfg.loss_angle_reg_weight,
            "loss_center": cfg.loss_center_weight,
            "loss_size": cfg.loss_size_weight,
        }

    # ---- matcher (reference criterion.py:101-228) ----
    @torch.no_grad()
    def build_cost(self, outputs: Tensors, targets: Tensors):
        """(B, nprop, K) matching cost; columns past each sample's GT
        count are 1e6 so that they never win."""
        c = self.cfg
        gt_labels = targets["gt_box_sem_cls_label"]
        B, nprop = outputs["objectness_prob"].shape
        K = gt_labels.shape[1]
        if c.use_focal:
            p = torch.sigmoid(outputs["sem_cls_prob"])  # logits for focal
            alpha, gamma = 0.25, 2.0
            neg = (1 - alpha) * p ** gamma * (-torch.log(1 - p + 1e-8))
            pos = alpha * (1 - p) ** gamma * (-torch.log(p + 1e-8))
            cost_src = pos - neg
        else:
            cost_src = -outputs["sem_cls_prob"]
        class_mat = cost_src.gather(2, gt_labels[:, None, :].expand(B, nprop,
                                                                    K))
        cost = (c.matcher_cls_cost * class_mat
                + c.matcher_center_cost * outputs["center_reg_dist"]
                + c.matcher_giou_cost * (-outputs["gious"])
                + c.matcher_size_cost * outputs["size_reg_dist"])
        if c.matcher_objectness_cost != 0:
            cost = cost + c.matcher_objectness_cost * (
                -outputs["objectness_prob"][..., None])
        angle_idx = targets["gt_angle_class_label"][:, None, :].expand(
            B, nprop, K)
        if c.matcher_anglecls_cost != 0:
            cost = cost + c.matcher_anglecls_cost * (
                -outputs["angle_logits"].gather(2, angle_idx))
        if c.matcher_anglereg_cost != 0:
            nbins = outputs["angle_residual_normalized"].shape[-1]
            gt_res = targets["gt_angle_residual_label"] / (np.pi / nbins)
            res = outputs["angle_residual_normalized"].gather(2, angle_idx)
            cost = cost + c.matcher_anglereg_cost * huber_loss(
                res - gt_res[:, None, :])
        kmask = (torch.arange(K, device=cost.device)[None, :]
                 < targets["nactual_gt"][:, None])
        return torch.where(kmask[:, None, :], cost, 1e6)

    @staticmethod
    def assignment_from_col4row(col4row, nprop: int):
        """col4row (B, K) -> {per_prop_gt_inds (B, nprop) int64,
        proposal_matched_mask (B, nprop) float} on col4row's device: each
        proposal matched to a GT row holds that row's index."""
        B, K = col4row.shape
        col4row = col4row.long()
        valid = (col4row >= 0) & (col4row < nprop)
        slot = torch.where(valid, col4row, nprop)  # an overflow slot
        gt_ids = torch.arange(K, device=col4row.device).expand(B, K)
        inds = torch.zeros(B, nprop + 1, dtype=torch.int64,
                           device=col4row.device)
        inds.scatter_(1, slot, torch.where(valid, gt_ids, 0))
        matched = torch.zeros(B, nprop + 1, device=col4row.device)
        matched.scatter_(1, slot, valid.float())
        return {"per_prop_gt_inds": inds[:, :nprop],
                "proposal_matched_mask": matched[:, :nprop]}

    def solve_costs(self, costs: List[torch.Tensor],
                    nactual: List[torch.Tensor], repeats: List[int]):
        """Assign every job's valid GT rows to distinct proposals. Jobs of
        one cost shape and repeat are solved together (JAX
        criterion.py:445-465); `repeats[j] > 1` marks a repeat-tiled job,
        which the auction solves by the capacity auction when K is a
        multiple of it. Returns per job {per_prop_gt_inds (B, nprop)
        int64, proposal_matched_mask (B, nprop) float} on the costs'
        device."""
        groups = {}
        for j, (cost, rep) in enumerate(zip(costs, repeats)):
            groups.setdefault((tuple(cost.shape[1:]), rep), []).append(j)
        if self.cfg.matcher_impl == "jv":
            # one device-to-host copy for every job
            host = torch.cat([x.reshape(-1).float() for x in costs]
                             + [n.reshape(-1).float() for n in nactual]
                             ).cpu().numpy()
            at, parts, host_n = 0, [], []
            for x in costs:
                parts.append(host[at:at + x.numel()].reshape(x.shape))
                at += x.numel()
            for n in nactual:
                host_n.append(host[at:at + n.numel()].astype(np.int64))
                at += n.numel()
        out = [None] * len(costs)
        for ((nprop, K), rep), idx in groups.items():
            B = costs[idx[0]].shape[0]
            if self.cfg.matcher_impl == "jv":
                costT = np.swapaxes(np.concatenate([parts[j] for j in idx]),
                                    1, 2)
                if K > nprop:  # more GT slots than proposals: dummy columns
                    costT = np.concatenate([costT, np.full(
                        (costT.shape[0], K, K - nprop), 1e6, np.float32)], 2)
                col4row = torch.from_numpy(hungarian(costT, np.concatenate(
                    [host_n[j] for j in idx]))).to(costs[0].device)
            else:
                costT = torch.cat([costs[j] for j in idx]).transpose(1, 2)
                if K > nprop:
                    costT = torch.cat([costT, costT.new_full(
                        (costT.shape[0], K, K - nprop), 1e6)], 2)
                n_valid = torch.cat([nactual[j] for j in idx])
                if rep > 1 and K % rep == 0:
                    col4row = auction_capacity(costT, n_valid, rep)
                else:
                    col4row = auction(costT, n_valid)
            assign = self.assignment_from_col4row(col4row, nprop)
            for i, j in enumerate(idx):
                out[j] = {k: v[i * B:(i + 1) * B] for k, v in assign.items()}
        return out

    # ---- per-output losses (reference criterion.py:334-530) ----
    def _losses(self, outputs, targets, assignments, num_boxes, has_boxes):
        c = self.cfg
        inds = assignments["per_prop_gt_inds"]
        mask = assignments["proposal_matched_mask"]
        losses = {}

        logits = outputs["sem_cls_logits"]
        C = logits.shape[-1]
        gt_label = targets["gt_box_sem_cls_label"].gather(1, inds)
        gt_label = torch.where(mask > 0, gt_label, C)  # background: all 0
        onehot = F.one_hot(gt_label, C + 1)[..., :C].to(logits.dtype)
        losses["loss_sem_cls"] = sigmoid_focal_loss_sum(
            logits, onehot, alpha=c.focal_alpha) / num_boxes * has_boxes

        nbins = outputs["angle_logits"].shape[-1]
        gt_angle_cls = targets["gt_angle_class_label"].gather(1, inds)
        logp = torch.log_softmax(outputs["angle_logits"], dim=-1)
        cls_nll = -logp.gather(-1, gt_angle_cls[..., None])[..., 0]
        losses["loss_angle_cls"] = ((cls_nll * mask).sum() / num_boxes
                                    * has_boxes)
        gt_res = (targets["gt_angle_residual_label"] / (np.pi / nbins)
                  ).gather(1, inds)
        res = outputs["angle_residual_normalized"].gather(
            -1, gt_angle_cls[..., None])[..., 0]
        losses["loss_angle_reg"] = (huber_loss(res - gt_res) * mask
                                    ).sum() / num_boxes * has_boxes

        center = outputs["center_reg_dist"].gather(2, inds[..., None])[..., 0]
        losses["loss_center"] = ((center * mask).sum() / num_boxes
                                 * has_boxes)
        giou = (1.0 - outputs["gious"]).gather(2, inds[..., None])[..., 0]
        losses["loss_giou"] = (giou * mask).sum() / num_boxes * has_boxes

        gt_sizes = _take(targets["gt_box_sizes"], inds)
        gt_size_reg = torch.log((gt_sizes + 1e-5) / (
            outputs["pre_box_size_unnormalized"] + 1e-5))
        size_l1 = (gt_size_reg - outputs["size_reg"]).abs().sum(-1)
        losses["loss_size"] = ((size_l1 * mask).sum() / num_boxes
                               * has_boxes)

        # cardinality: logged only (reference criterion.py:262-271)
        with torch.no_grad():
            pred_objects = (logits.argmax(-1) != C - 1).sum(1)
            losses["loss_cardinality"] = (
                pred_objects.float() - targets["nactual_gt"].float()
            ).abs().mean()
        return losses

    def prepare_output(self, outputs: Tensors, targets: Tensors) -> Tensors:
        """Attach the GIoU, center and size distance matrices (reference
        criterion.py:620-645)."""
        outputs = dict(outputs)
        outputs["gious"] = generalized_box3d_iou(
            outputs["box_corners"], targets["gt_box_corners"],
            targets["nactual_gt"])
        pre_c = outputs["pre_box_center_unnormalized"][:, :, None, :]
        pre_s = outputs["pre_box_size_unnormalized"][:, :, None, :]
        gt_center_reg = ((targets["gt_box_centers"][:, None, :, :] - pre_c)
                         / (pre_s + 1e-5))
        outputs["center_reg_dist"] = (
            outputs["center_reg"][:, :, None, :] - gt_center_reg).abs().sum(-1)
        gt_size_reg = torch.log(
            (targets["gt_box_sizes"][:, None, :, :] + 1e-5) / (pre_s + 1e-5))
        outputs["size_reg_dist"] = (
            outputs["size_reg"][:, :, None, :] - gt_size_reg).abs().sum(-1)
        return outputs

    def compute_losses(self, outputs, targets, assignments, num_boxes,
                       has_boxes) -> Tuple[torch.Tensor, Tensors]:
        losses = self._losses(outputs, targets, assignments, num_boxes,
                              has_boxes)
        total = torch.zeros((), device=num_boxes.device)
        for k, w in self.loss_weights.items():
            if w > 0:
                losses[k] = losses[k] * w
                total = total + losses[k]
        return total, losses

    # ---- encoder point-cls loss (reference criterion.py:273-332) ----
    def loss_point_cls(self, enc_outputs, targets, num_boxes, has_boxes):
        c = self.cfg
        boxes = torch.cat([targets["gt_box_centers"], targets["gt_box_sizes"],
                           targets["gt_box_angles"][..., None]], dim=-1)
        # bottom-centered z
        boxes = torch.cat([boxes[..., :2],
                           boxes[..., 2:3] - boxes[..., 5:6] / 2,
                           boxes[..., 3:]], dim=-1)
        inbox = points_in_boxes_all(enc_outputs["seed_xyz"], boxes)
        B, npts, K = inbox.shape
        kmask = (torch.arange(K, device=inbox.device)[None, None, :]
                 < targets["nactual_gt"][:, None, None])
        vol = targets["gt_box_sizes"].prod(-1)
        weighted = inbox * kmask * vol[:, None, :]
        weighted = torch.where(weighted == 0, 1000.0, weighted)
        weighted = torch.cat([weighted, weighted.new_full((B, npts, 1),
                                                          100.0)], dim=-1)
        assign = weighted.argmin(dim=-1)
        matched = assign != K
        assign = torch.where(matched, assign, 0)
        logits = enc_outputs["point_cls_logits"]
        C = logits.shape[-1]
        gt_label = targets["gt_box_sem_cls_label"].gather(1, assign)
        gt_label = torch.where(matched, gt_label, C)
        onehot = F.one_hot(gt_label, C + 1)[..., :C].to(logits.dtype)
        loss = sigmoid_focal_loss_sum(logits, onehot, alpha=c.focal_alpha)
        return loss / num_boxes * has_boxes

    def __call__(self, outputs, targets: Tensors):
        """Returns (total_loss, loss_dict)."""
        c = self.cfg
        targets = dict(targets)
        nactual = targets["gt_box_present"].sum(1).to(torch.int64)
        targets["nactual_gt"] = nactual
        total_gt = nactual.sum().float()
        # jobs against repeated GT normalize by repeat * N, the
        # un-repeated bilabel aux0 and the point-cls loss by N
        # (reference criterion.py:612-616, 670-676)
        num_boxes = total_gt.clamp(min=1.0)
        has_boxes = (total_gt > 0).float()
        if c.repeat_num > 1:
            targets_rep = repeat_ground_truth(targets, c.repeat_num)
            num_boxes_rep = (total_gt * c.repeat_num).clamp(min=1.0)
        else:
            targets_rep, num_boxes_rep = targets, num_boxes

        rep = max(c.repeat_num, 1)
        jobs = [("final", outputs["outputs"], targets_rep, num_boxes_rep,
                 rep)]
        for k, aux in enumerate(outputs.get("aux_outputs", [])):
            if k == 0 and c.is_bilable:
                bin_targets = dict(targets)
                bin_targets["gt_box_sem_cls_label"] = torch.zeros_like(
                    targets["gt_box_sem_cls_label"])
                jobs.append((f"aux{k}", aux, bin_targets, num_boxes, 1))
            else:
                jobs.append((f"aux{k}", aux, targets_rep, num_boxes_rep,
                             rep))
        prepared = [(tag, self.prepare_output(out, tgt), tgt, nb)
                    for tag, out, tgt, nb, _ in jobs]
        assignments = self.solve_costs(
            [self.build_cost(out, tgt) for _, out, tgt, _ in prepared],
            [tgt["nactual_gt"] for _, _, tgt, _ in prepared],
            [jrep for *_, jrep in jobs])

        loss = torch.zeros((), device=num_boxes.device)
        loss_dict = {}
        for (tag, out, tgt, nb), assign in zip(prepared, assignments):
            part_loss, part = self.compute_losses(out, tgt, assign, nb,
                                                  has_boxes)
            loss = loss + part_loss
            if tag == "final":
                loss_dict.update(part)
            else:
                loss_dict.update({f"{kk}_{tag[3:]}": vv
                                  for kk, vv in part.items()})

        if "enc_outputs" in outputs:
            enc = dict(outputs["enc_outputs"])
            enc["seed_xyz"] = outputs["seed_xyz"]
            enc_loss = (self.loss_point_cls(enc, targets, num_boxes,
                                            has_boxes)
                        * c.point_cls_loss_weight)
            loss = loss + enc_loss
            loss_dict["enc_point_cls_loss"] = enc_loss
        return loss, loss_dict
