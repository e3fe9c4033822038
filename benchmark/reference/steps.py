"""The train step and the eval step, plain (frozen copy of
`vdetr_tpu_torch/train/engine.py`, `train/optimizer.py`,
`train/schedule.py`, `geometry/points_in_boxes.py:points_in_boxes_count`
and the plain NMS loop of `geometry/nms.py`)."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference.config import ref_config
from benchmark.reference.criterion import SetCriterion, points_in_boxes_all
from benchmark.reference.model import VDETR

INPUT_KEYS = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max",
              "point_validity")
EVAL_KEYS = ("box_corners", "box_corners_axis_align", "sem_cls_prob",
             "objectness_prob", "angle_prob", "center_unnormalized",
             "size_unnormalized", "angle_continuous")
EMPTY_BOX_POINTS = 40000


def build(conf: dict, device):
    """(cfg, model, criterion) of a configuration file, on `device`; the
    caller loads the weights."""
    cfg = ref_config(conf)
    ds = conf["dataset_config"]
    with torch.device(device):
        model = VDETR(cfg, ds["num_semcls"], ds["num_angle_bin"],
                      ds["mean_size_arr"])
    return cfg, model.to(device), SetCriterion(cfg, ds["num_angle_bin"])


def lr_at(cfg, steps_per_epoch: int, step: int) -> float:
    """Linear warm-up, then cosine (`lr_scheduler` "cosine")."""
    max_steps = max(cfg.max_epoch * steps_per_epoch, 1)
    warm_frac = cfg.warm_lr_epochs / cfg.max_epoch if cfg.max_epoch else 0.0
    cen = min(max(step / max_steps, 0.0), 1.0)
    if cen <= warm_frac and cfg.warm_lr_epochs > 0:
        return cfg.warm_lr + cen * cfg.max_epoch * (
            (cfg.base_lr - cfg.warm_lr) / max(cfg.warm_lr_epochs, 1))
    if cfg.lr_scheduler != "cosine":
        raise ValueError("the reference covers the cosine schedule")
    return cfg.final_lr + 0.5 * (cfg.base_lr - cfg.final_lr) * (
        1 + math.cos(math.pi * cen))


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float):
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    if bool(norm >= max_norm):
        for g in grads:
            g.div_(norm).mul_(max_norm)


def train_steps(cfg, model, criterion, batches: List[Dict[str, torch.Tensor]],
                generator: torch.Generator, steps_per_epoch: int,
                decisions=None):
    """Train steps on `batches` from the model's weights. `decisions`, one
    {"topk", "assign", "angle_cls", "size_cls"} a step, each key optional,
    replace the proposals' choice, the matcher's assignments, the boxes'
    angle classes and the seeds' size-prior classes. Returns {"losses", "first_grads" and "params" ({name:
    tensor}: the clipped gradients of the first step, the parameters
    after the last), "decisions" (the ones taken), "scores" (each step's
    layer-0 proposal scores and validity), "assign_excess"
    (`criterion.assignment_excess` of the given assignments),
    "class_margin" (each step's largest logit by which another class
    beats an angle or size-prior class taken: `decoder.angle_margin`,
    `VDETR.forward`'s "prior_margin")}."""
    params = [p for p in model.parameters() if p.requires_grad]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    opt = torch.optim.AdamW(params, lr=cfg.base_lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.weight_decay,
                            foreach=False)
    model.train()
    losses, first_grads = [], None
    taken, scores, excess, margins = [], [], [], []
    for step, batch in enumerate(batches):
        given = decisions[step] if decisions is not None else {}
        for g in opt.param_groups:
            g["lr"] = lr_at(cfg, steps_per_epoch, step)
        opt.zero_grad(set_to_none=True)
        outputs = model({k: batch[k] for k in INPUT_KEYS},
                        generator=generator, topk=given.get("topk"),
                        angle_cls=given.get("angle_cls"),
                        size_cls=given.get("size_cls"))
        loss, _ = criterion(outputs, batch, given.get("assign"))
        taken.append({"topk": outputs["topk"],
                      "assign": given.get("assign",
                                          criterion.own_assignments),
                      "angle_cls": outputs["angle_cls"]}
                     | ({"size_cls": outputs["size_cls"]}
                        if outputs["size_cls"] is not None else {}))
        scores.append((outputs["proposal_scores"].detach(),
                       outputs["seed_valid"]))
        excess.append(criterion.assign_excess)
        margins.append(max(float(outputs["angle_margin"]),
                           float(outputs["prior_margin"])))
        loss.backward()
        del outputs
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if cfg.clip_gradient > 0:
            clip_by_global_norm(params, cfg.clip_gradient)
        losses.append(float(loss.detach()))
        if step == 0:
            first_grads = {n: p.grad.detach().clone()
                           for n, p in zip(names, params)}
        opt.step()
    return {"losses": losses, "first_grads": first_grads,
            "params": {n: p.detach().clone() for n, p in zip(names, params)},
            "decisions": taken, "scores": scores, "assign_excess": excess,
            "class_margin": margins}


def points_in_boxes_count(points, boxes, chunk: int = 4096):
    B, N, _ = points.shape
    count = torch.zeros(boxes.shape[:2], dtype=torch.int64,
                        device=boxes.device)
    for start in range(0, N, chunk):
        inside = points_in_boxes_all(points[:, start:start + chunk], boxes)
        count += inside.sum(1, dtype=torch.int64)
    return count


def empty_box_subsample(n: int, device) -> torch.Tensor:
    """The fixed subsample of min(40000, n) points the empty-box counts
    read: a permutation from a generator seeded 0 on the device."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randperm(n, generator=gen, device=device)[:EMPTY_BOX_POINTS]


def nms_keep_plain(aabbs, scores, classes, valid, iou_threshold):
    """Greedy same-class NMS, one scene at a time: while a box is alive,
    keep the alive box of the largest score (the lowest index among
    equal ones) and kill it and every same-class box whose overlap with
    it is > iou_threshold."""
    x1, y1, z1, x2, y2, z2 = aabbs.unbind(-1)
    area = (x2 - x1) * (y2 - y1) * (z2 - z1)

    def lo(a):
        return torch.maximum(a[:, :, None], a[:, None, :])

    def hi(a):
        return torch.minimum(a[:, :, None], a[:, None, :])

    inter = ((hi(x2) - lo(x1)).clamp(min=0.0)
             * (hi(y2) - lo(y1)).clamp(min=0.0)
             * (hi(z2) - lo(z1)).clamp(min=0.0))
    ov = inter / (area[:, :, None] + area[:, None, :] - inter).clamp(
        min=1e-12)
    ov = torch.where(classes[:, :, None] == classes[:, None, :], ov,
                     torch.zeros((), dtype=ov.dtype, device=ov.device))
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


@torch.no_grad()
def nms_keep(cfg, out: Dict[str, torch.Tensor], point_clouds):
    """The eval step's keep mask of the outputs `out`: empty boxes (fewer
    than `empty_pt_thre` points of the fixed subsample, a scene's best box
    kept where all are empty) out, then the same-class NMS of the AABBs."""
    boxes = torch.cat([out["center_unnormalized"], out["size_unnormalized"],
                       out["angle_continuous"][..., None]], dim=-1)
    boxes[..., 2] -= boxes[..., 5] / 2
    pc = point_clouds[..., :3]
    pc = pc[:, empty_box_subsample(pc.shape[1], pc.device)]
    valid = points_in_boxes_count(pc, boxes) >= cfg.empty_pt_thre
    obj = out["objectness_prob"]
    none = ~valid.any(dim=1, keepdim=True)
    best = torch.nn.functional.one_hot(obj.argmax(dim=1),
                                       obj.shape[1]).bool()
    valid = valid | (none & best)
    corners = out["box_corners"]
    aabbs = torch.cat([corners.min(dim=2).values,
                       corners.max(dim=2).values], dim=-1)
    classes = out["sem_cls_prob"].argmax(dim=-1)
    return nms_keep_plain(aabbs, obj, classes, valid, cfg.nms_iou)


@torch.no_grad()
def proposals(model, batch):
    """(seed_xyz, seed_valid, layer-0 scores, the proposals' choice) of
    the eval forward."""
    model.eval()
    res = model({k: batch[k] for k in INPUT_KEYS}, proposals_only=True)
    return res["seed_xyz"], res["seed_valid"], res["proposal_scores"], \
        res["topk"]


@torch.no_grad()
def eval_step(cfg, model, batch, topk=None, keep=True):
    """The eval forward, the focal sigmoid, and (`keep`) the keep mask of
    empty-box removal and NMS (`test_only`); `topk` (B, nq) replaces the
    proposals' choice."""
    model.eval()
    res = model({k: batch[k] for k in INPUT_KEYS}, topk=topk)
    final = dict(res["outputs"])
    if cfg.use_focal:
        final["sem_cls_prob"] = torch.sigmoid(final["sem_cls_prob"])
    out = {k: final[k] for k in EVAL_KEYS}
    if keep:
        out["nms_keep"] = nms_keep(cfg, out, batch["point_clouds"])
    return out
