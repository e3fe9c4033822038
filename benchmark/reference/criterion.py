"""The set criterion with the auction matcher, plain (frozen copy of
`vdetr_tpu_torch/train/criterion.py` (one process, `matcher_impl`
"auction", `iou_type` "giou"), the plain auctions of `ops/hungarian.py`,
the GIoU of `geometry/iou.py`, the plain rotated clip of
`ops/rotated_iou.py` and `geometry/points_in_boxes.py`).

The rotated bird's-eye intersections are clipped for the gated pairs
only and differentiated by autograd, so that the graph of the clip loop
holds a few thousand pairs, not every pair of the batch.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]
EPS = 1e-8
VOL_EPS = 1e-6
MAXV = 16

# --------------------------------------------------------------------------
# the auction (eps-optimal forward auction, batched problems in lockstep)
# --------------------------------------------------------------------------


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _order_key(x):
    bits = x.view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _eps(values, genuine, eps_frac: float):
    inf = _f32(np.inf, values)
    vmax = torch.where(genuine, values, -inf).amax(dim=(1, 2))
    vmin = torch.where(genuine, values, inf).amin(dim=(1, 2))
    spread = vmax - vmin
    spread = torch.where(torch.isfinite(spread), spread, _f32(1.0, values))
    spread = torch.maximum(spread, _f32(1e-3, values))
    return _f32(eps_frac, values) * spread


def auction(cost, n_valid, eps_frac: float = 0.002, max_iters: int = 3000):
    """col4row (P, n) of cost (P, n, m): every unassigned row bids on its
    best column each round, the best bid (the lowest row among equal
    bids) takes the column and evicts its holder."""
    cost = cost.float()
    P, n, m = cost.shape
    dev = cost.device
    values = -cost
    row_ids = torch.arange(n, device=dev)
    row_valid = row_ids[None, :] < n_valid.to(dev)[:, None]
    eps = _eps(values, row_valid[:, :, None] & (cost < 1e5), eps_frac)[:,
                                                                      None]
    neg_inf = _f32(-np.inf, cost)
    col4row = torch.full((P, n), -1, dtype=torch.int64, device=dev)
    prices = torch.zeros(P, m, dtype=torch.float32, device=dev)
    rounds = torch.zeros(P, dtype=torch.int64, device=dev)
    while True:
        unassigned = row_valid & (col4row < 0)
        active = unassigned.any(dim=1) & (rounds < max_iters)
        if not bool(active.any()):
            break
        net = values - prices[:, None, :]
        j1 = net.argmax(dim=2)
        v1 = net.gather(2, j1[:, :, None])[:, :, 0]
        v2 = net.scatter(2, j1[:, :, None], -np.inf).amax(dim=2)
        v2 = torch.where(torch.isfinite(v2), v2, v1 - eps)
        bid = prices.gather(1, j1) + (v1 - v2) + eps
        bid = torch.where(unassigned, bid, neg_inf)
        col_best = torch.full((P, m), -np.inf, device=dev).scatter_reduce(
            1, j1, bid, "amax")
        maybe_won = unassigned & (bid >= col_best.gather(1, j1))
        winner = torch.full((P, m), n, device=dev).scatter_reduce(
            1, j1, torch.where(maybe_won, row_ids, n), "amin")
        won = maybe_won & (winner.gather(1, j1) == row_ids)
        has_winner = winner < n
        held = col4row.clamp(0, m - 1)
        evicted = ((col4row >= 0) & has_winner.gather(1, held)
                   & (winner.gather(1, held) != row_ids))
        new = torch.where(evicted, -1, col4row)
        new = torch.where(won, j1, new)
        col4row = torch.where(active[:, None], new, col4row)
        prices = torch.where(active[:, None] & has_winner, col_best, prices)
        rounds = rounds + active.long()
    return torch.where(row_valid, col4row, -1).to(torch.int32)


def auction_capacity(cost, n_valid, repeat: int, eps_frac: float = 0.002,
                     max_iters: int = 3000):
    """The capacity auction of the repeat-tiled GT rows: class c (row c
    of the first g = n_valid / repeat) bids for `repeat` columns; then
    class c's columns go to its copies c, c + g, ... in column order."""
    cost = cost.float()
    P, n, m = cost.shape
    dev = cost.device
    g_max = n // repeat
    n_valid = n_valid.to(dev)
    g = n_valid // repeat
    class_ids = torch.arange(g_max, device=dev)
    class_valid = class_ids[None, :] < g[:, None]
    values = -cost[:, :g_max]
    cap = torch.where(class_valid, repeat, 0)
    eps = _eps(values, class_valid[:, :, None] & (cost[:, :g_max] < 1e5),
               eps_frac)[:, None, None]
    neg = _f32(-1e30, cost)
    half = neg / 2
    neg_inf = _f32(-np.inf, cost)
    slot = torch.arange(repeat + 1, device=dev)
    col4class = torch.full((P, m), -1, dtype=torch.int64, device=dev)
    prices = torch.zeros(P, m, dtype=torch.float32, device=dev)
    rounds = torch.zeros(P, dtype=torch.int64, device=dev)
    while True:
        own = col4class[:, None, :] == class_ids[None, :, None]
        need = cap - own.sum(dim=2)
        active = (need > 0).any(dim=1) & (rounds < max_iters)
        if not bool(active.any()):
            break
        net = values - prices[:, None, :]
        net = torch.where(own | ~class_valid[:, :, None], neg, net)
        topj = torch.sort(_order_key(net), dim=2, descending=True,
                          stable=True).indices[:, :, :repeat + 1]
        topv = net.gather(2, topj)
        vcut = topv.gather(2, need.clamp(0, repeat)[:, :, None])
        bidding = ((slot < need[:, :, None]) & (topv > half)
                   & (vcut > half))
        flat_j = topj.reshape(P, -1)
        bid = (prices.gather(1, flat_j).reshape(topj.shape) + (topv - vcut)
               + eps)
        flat_b = torch.where(bidding, bid, neg_inf).reshape(P, -1)
        flat_c = class_ids[None, :, None].expand(topj.shape).reshape(P, -1)
        col_best = torch.full((P, m), -np.inf, device=dev).scatter_reduce(
            1, flat_j, flat_b, "amax")
        cand = torch.where(torch.isfinite(flat_b)
                           & (flat_b >= col_best.gather(1, flat_j)),
                           flat_c, g_max)
        winner = torch.full((P, m), g_max, device=dev).scatter_reduce(
            1, flat_j, cand, "amin")
        upd = active[:, None] & (winner < g_max) & torch.isfinite(col_best)
        col4class = torch.where(upd, winner, col4class)
        prices = torch.where(upd, col_best, prices)
        rounds = rounds + active.long()
    onehot = col4class[:, None, :] == class_ids[None, :, None]
    rank = torch.cumsum(onehot.long(), dim=2) - 1
    rk = rank.gather(1, col4class.clamp(0, max(g_max - 1, 0))[:, None, :]
                     )[:, 0]
    row = torch.where(col4class >= 0, col4class + g[:, None] * rk, n)
    col4row = torch.full((P, n + 1), -1, dtype=torch.int64, device=dev)
    col4row.scatter_(1, row, torch.arange(m, device=dev).expand(P, m))
    col4row = col4row[:, :n]
    row_valid = torch.arange(n, device=dev)[None, :] < n_valid[:, None]
    return torch.where(row_valid, col4row, -1).to(torch.int32)


# --------------------------------------------------------------------------
# boxes' overlaps
# --------------------------------------------------------------------------

def _put(buf, slot, flag, v, slots):
    sel = (slots == slot[..., None]) & flag[..., None]
    return torch.where(sel[..., None], v[..., None, :], buf)


def _take(buf, slot):
    idx = slot.clamp(0, MAXV - 1)[..., None, None].expand(slot.shape + (1, 2))
    return buf.gather(-2, idx)[..., 0, :]


def clip_quad_quad(subject, clip):
    """Intersection areas of quads `subject` clipped by convex CCW quads
    `clip`, (..., 4, 2) each (Sutherland-Hodgman in a 16-vertex buffer)."""
    subject, clip = torch.broadcast_tensors(subject, clip)
    shape = subject.shape[:-2]
    dev = subject.device
    slots = torch.arange(MAXV, device=dev)
    poly = torch.cat([subject, subject.new_zeros(shape + (MAXV - 4, 2))], -2)
    n = torch.full(shape, 4, dtype=torch.int64, device=dev)
    for edge in range(4):
        cp1 = clip[..., (edge + 3) % 4, :]
        cp2 = clip[..., edge, :]
        d = cp2 - cp1
        dc = -d
        n1 = cp1[..., 0] * cp2[..., 1] - cp1[..., 1] * cp2[..., 0]

        def inside(p):
            return (d[..., 0] * (p[..., 1] - cp1[..., 1])
                    > d[..., 1] * (p[..., 0] - cp1[..., 0]))

        out = torch.zeros_like(poly)
        m = torch.zeros_like(n)
        s = _take(poly, n - 1)
        for i in range(MAXV):
            valid = i < n
            e = poly[..., i, :]
            ins_e, ins_s = inside(e), inside(s)
            add_x = valid & (ins_e != ins_s)
            dp = s - e
            n2 = s[..., 0] * e[..., 1] - s[..., 1] * e[..., 0]
            den = dc[..., 0] * dp[..., 1] - dc[..., 1] * dp[..., 0] + 1e-30
            n3 = torch.reciprocal(torch.where(add_x, den, 1.0))
            x = torch.stack([(n1 * dp[..., 0] - n2 * dc[..., 0]) * n3,
                             (n1 * dp[..., 1] - n2 * dc[..., 1]) * n3], -1)
            out = _put(out, m, add_x, x, slots)
            m = m + add_x
            add_e = valid & ins_e
            out = _put(out, m, add_e, e, slots)
            m = m + add_e
            s = torch.where(valid[..., None], e, s)
        poly, n = out, m
    x, y = poly[..., 0], poly[..., 1]
    nxt = torch.where(slots + 1 < n[..., None],
                      (slots + 1).clamp(max=MAXV - 1), 0)
    contrib = torch.where(slots < n[..., None],
                          x * y.gather(-1, nxt) - y * x.gather(-1, nxt), 0.0)
    total = contrib[..., 0]
    for i in range(1, MAXV):
        total = total + contrib[..., i]
    return torch.where(n >= 3, 0.5 * total.abs(), 0.0)


def rotated_areas(rect1, rect2, gate):
    """(B, K1, K2) areas of rect1 (B, K1, 4, 2) clipped by rect2 (B, K2,
    4, 2), 0 where the gate is off: the clip runs on the gated pairs only
    (a few in a thousand), differentiated by autograd."""
    b, i, j = gate.nonzero(as_tuple=True)
    areas = clip_quad_quad(rect1[b, i], rect2[b, j])
    return torch.zeros(gate.shape, dtype=rect1.dtype,
                       device=rect1.device).index_put((b, i, j), areas)


def box3d_vol_corners(corners):
    def edge(i, j):
        d2 = ((corners[..., i, :] - corners[..., j, :]) ** 2).sum(-1)
        return torch.sqrt(d2.clamp(min=VOL_EPS))
    return edge(0, 1) * edge(1, 2) * edge(0, 4)


def enclosing_box3d_vol(corners1, corners2):
    mn1, mx1 = corners1.min(dim=2).values, corners1.max(dim=2).values
    mn2, mx2 = corners2.min(dim=2).values, corners2.max(dim=2).values
    lo = torch.minimum(mn1[:, :, None, :], mn2[:, None, :, :])
    hi = torch.maximum(mx1[:, :, None, :], mx2[:, None, :, :])
    d = (hi - lo).abs()
    return d[..., 0] * d[..., 1] * d[..., 2]


def _bev_rects(corners):
    return corners[..., :4, :].flip(-2)[..., ::2]


def generalized_box3d_iou(corners1, corners2, nums_k2, rotated_boxes=False):
    """(B, K1, K2) GIoU of camera-frame corners; `rotated_boxes`: the
    bird's-eye intersection is the clip of the two rects, taken where
    the rects' corners 1 and 3 overlap as an axis-aligned box."""
    K2 = corners2.shape[1]
    ymax = torch.minimum(corners1[:, :, 0, 1][:, :, None],
                         corners2[:, :, 0, 1][:, None, :])
    ymin = torch.maximum(corners1[:, :, 4, 1][:, :, None],
                         corners2[:, :, 4, 1][:, None, :])
    height = (ymax - ymin).clamp(min=0.0)
    bev1 = torch.stack([corners1[:, :, 2], corners1[:, :, 0]], 2)[..., ::2]
    bev2 = torch.stack([corners2[:, :, 2], corners2[:, :, 0]], 2)[..., ::2]
    lt = torch.maximum(bev1[:, :, None, 0, :], bev2[:, None, :, 0, :])
    rb = torch.minimum(bev1[:, :, None, 1, :], bev2[:, None, :, 1, :])
    wh = (rb - lt).clamp(min=0.0)
    inter_areas = wh[..., 0] * wh[..., 1]
    k2_mask = (torch.arange(K2, device=corners2.device)[None, :]
               < nums_k2[:, None])
    inter_areas = inter_areas * k2_mask[:, None, :]
    enclosing = enclosing_box3d_vol(corners1, corners2)
    vols1 = box3d_vol_corners(corners1).clamp(min=EPS)
    vols2 = box3d_vol_corners(corners2).clamp(min=EPS)
    sum_vols = vols1[:, :, None] + vols2[:, None, :]
    good = (enclosing > 2 * EPS) & (sum_vols > 4 * EPS)
    if rotated_boxes:
        inter_areas = rotated_areas(_bev_rects(corners1), _bev_rects(corners2),
                                    inter_areas > 0)
    inter_vols = inter_areas * height
    union_vols = (sum_vols - inter_vols).clamp(min=EPS)
    gious = inter_vols / union_vols - (1.0 - union_vols / enclosing)
    gious = torch.where(good, gious, 0.0)
    return gious * k2_mask[:, None, :]


def points_in_boxes_all(points, boxes):
    """points (B, N, 3), boxes (B, T, 7) bottom-centred, yaw about z ->
    (B, N, T) float 0/1."""
    center, dims, yaw = boxes[..., 0:3], boxes[..., 3:6], boxes[..., 6]
    d = points[:, :, None, :] - center[:, None, :, :]
    c = torch.cos(-yaw)[:, None, :]
    s = torch.sin(-yaw)[:, None, :]
    lx = d[..., 0] * c - d[..., 1] * s
    ly = d[..., 0] * s + d[..., 1] * c
    lz = d[..., 2]
    inside = ((lx.abs() < dims[:, None, :, 0] * 0.5)
              & (ly.abs() < dims[:, None, :, 1] * 0.5)
              & (lz >= 0.0) & (lz <= dims[:, None, :, 2]))
    return inside.float()


# --------------------------------------------------------------------------
# the criterion
# --------------------------------------------------------------------------

def huber_loss(error, delta: float = 1.0):
    abs_error = error.abs()
    quadratic = torch.clamp(abs_error, max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def sigmoid_focal_loss_sum(logits, targets, alpha=0.25, gamma=2.0):
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
    out = dict(targets)
    present = targets["gt_box_present"].repeat(1, repeat)
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


def _take_rows(x, inds):
    idx = inds.reshape(inds.shape + (1,) * (x.ndim - 2))
    return x.gather(1, idx.expand(inds.shape + x.shape[2:]))


def _assigned_cost(cost, assign):
    """(B,) total cost of the matched (proposal, GT) pairs."""
    inds, mask = assign["per_prop_gt_inds"], assign["proposal_matched_mask"]
    return (cost.gather(2, inds[..., None])[..., 0] * mask).sum(dim=1)


@torch.no_grad()
def assignment_excess(costs, nactual, given, own, eps_frac: float = 0.002):
    """The largest excess, over every job and scene, of the total cost of
    the `given` assignments over the matcher's `own`, in units of the
    auction's guarantee: an eps-optimal auction's assignment costs at most
    n_valid eps more than the optimum, eps = eps_frac x the spread of the
    genuine costs (`_eps`), so two eps-optimal answers on one cost matrix
    differ by at most 1 in these units. inf where a given assignment does
    not fit its job or matches a proposal twice."""
    worst = 0.0
    for cost, n, g, o in zip(costs, nactual, given, own):
        B, nprop, K = cost.shape
        if tuple(g["per_prop_gt_inds"].shape) != (B, nprop):
            return float("inf")
        genuine = (torch.arange(K, device=cost.device)[None, None, :]
                   < n[:, None, None]) & (cost < 1e5)
        eps = _eps(-cost, genuine, eps_frac)
        matched = g["proposal_matched_mask"].sum(dim=1)
        if bool((matched != o["proposal_matched_mask"].sum(dim=1)).any()):
            return float("inf")
        excess = (_assigned_cost(cost, g) - _assigned_cost(cost, o)) / (
            n.clamp(min=1) * eps)
        worst = max(worst, float(excess.max()))
    return worst


class SetCriterion:
    def __init__(self, cfg, num_angle_bin: int):
        if cfg.matcher_impl != "auction" or cfg.iou_type != "giou":
            raise ValueError("the reference covers the auction matcher and "
                             "the GIoU")
        self.cfg = cfg
        self.rotated = num_angle_bin > 1
        self.loss_weights = {
            "loss_giou": cfg.loss_giou_weight,
            "loss_sem_cls": cfg.loss_sem_cls_weight,
            "loss_angle_cls": cfg.loss_angle_cls_weight,
            "loss_angle_reg": cfg.loss_angle_reg_weight,
            "loss_center": cfg.loss_center_weight,
            "loss_size": cfg.loss_size_weight,
        }

    @torch.no_grad()
    def build_cost(self, outputs, targets):
        c = self.cfg
        gt_labels = targets["gt_box_sem_cls_label"]
        B, nprop = outputs["objectness_prob"].shape
        K = gt_labels.shape[1]
        p = torch.sigmoid(outputs["sem_cls_prob"])
        alpha, gamma = 0.25, 2.0
        neg = (1 - alpha) * p ** gamma * (-torch.log(1 - p + 1e-8))
        pos = alpha * (1 - p) ** gamma * (-torch.log(p + 1e-8))
        cost_src = pos - neg
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
        B, K = col4row.shape
        col4row = col4row.long()
        valid = (col4row >= 0) & (col4row < nprop)
        slot = torch.where(valid, col4row, nprop)
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
        groups = {}
        for j, (cost, rep) in enumerate(zip(costs, repeats)):
            groups.setdefault((tuple(cost.shape[1:]), rep), []).append(j)
        out = [None] * len(costs)
        for ((nprop, K), rep), idx in groups.items():
            B = costs[idx[0]].shape[0]
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

    def _losses(self, outputs, targets, assignments, num_boxes, has_boxes):
        c = self.cfg
        inds = assignments["per_prop_gt_inds"]
        mask = assignments["proposal_matched_mask"]
        losses = {}
        logits = outputs["sem_cls_logits"]
        C = logits.shape[-1]
        gt_label = targets["gt_box_sem_cls_label"].gather(1, inds)
        gt_label = torch.where(mask > 0, gt_label, C)
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
        gt_sizes = _take_rows(targets["gt_box_sizes"], inds)
        gt_size_reg = torch.log((gt_sizes + 1e-5) / (
            outputs["pre_box_size_unnormalized"] + 1e-5))
        size_l1 = (gt_size_reg - outputs["size_reg"]).abs().sum(-1)
        losses["loss_size"] = ((size_l1 * mask).sum() / num_boxes
                               * has_boxes)
        return losses

    def prepare_output(self, outputs, targets):
        outputs = dict(outputs)
        outputs["gious"] = generalized_box3d_iou(
            outputs["box_corners"], targets["gt_box_corners"],
            targets["nactual_gt"], rotated_boxes=self.rotated)
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
                       has_boxes):
        losses = self._losses(outputs, targets, assignments, num_boxes,
                              has_boxes)
        total = torch.zeros((), device=num_boxes.device)
        for k, w in self.loss_weights.items():
            if w > 0:
                losses[k] = losses[k] * w
                total = total + losses[k]
        return total, losses

    def loss_point_cls(self, enc_outputs, targets, num_boxes, has_boxes):
        boxes = torch.cat([targets["gt_box_centers"], targets["gt_box_sizes"],
                           targets["gt_box_angles"][..., None]], dim=-1)
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
        loss = sigmoid_focal_loss_sum(logits, onehot,
                                      alpha=self.cfg.focal_alpha)
        return loss / num_boxes * has_boxes

    def __call__(self, outputs, targets: Tensors, assignments=None
                 ) -> Tuple[torch.Tensor, Tensors]:
        """The loss and its terms. `assignments` (per job, as
        `solve_costs` gives them), when given, replace the matcher's; the
        excess of their cost over the matcher's own is kept in
        `assign_excess` (`assignment_excess`), the matcher's own in
        `own_assignments`."""
        c = self.cfg
        targets = dict(targets)
        nactual = targets["gt_box_present"].sum(1).to(torch.int64)
        targets["nactual_gt"] = nactual
        total_gt = nactual.sum().float()
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
        costs = [self.build_cost(out, tgt) for _, out, tgt, _ in prepared]
        nactual = [tgt["nactual_gt"] for _, _, tgt, _ in prepared]
        own = self.solve_costs(costs, nactual, [jrep for *_, jrep in jobs])
        self.own_assignments = own
        self.assign_excess = (0.0 if assignments is None else
                              assignment_excess(costs, nactual, assignments,
                                                own))
        if assignments is None:
            assignments = own
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
        enc = dict(outputs["enc_outputs"])
        enc["seed_xyz"] = outputs["seed_xyz"]
        enc_loss = (self.loss_point_cls(enc, targets, num_boxes, has_boxes)
                    * c.point_cls_loss_weight)
        loss = loss + enc_loss
        loss_dict["enc_point_cls_loss"] = enc_loss
        return loss, loss_dict
