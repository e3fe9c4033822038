"""What decides `correct`: the program's outputs of the timed path against
the plain reference (`benchmark/reference/`), each number beside its
limit from `limits/<cell>.json`.

Training: set-up drives the program's trainer through its first steps
with the window's own call and feed; the reference follows the first
`check_steps` from the same weights, batches and dropout generator.
Compared, by the worst leaf where a norm is per leaf:
- `loss_gap`: |L_p - L_r| / |L_r| over the steps;
- `grad_gap`: the first step's gradient as the optimizer got it (from
  AdamW's first moment after one step), |n_p - n_r| / max(n_r, median
  n_r) of each leaf's norm;
- `delta_gap`: the same of the parameters' change over the steps.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both (they move by round-off alone).

Evaluation: after the window, a sample of the steps it completed, drawn
from the seed, is judged:
- `order_gap`: the proposals' choice. Each query of the program is
  tied to its proposal by its box centre (the eval weights keep the
  centre head's offsets to about a centimetre, under half the seeds'
  spacing); the program's order must sort the reference's layer-0
  scores, up to this gap: the largest score by which a later query, or
  a proposal left out, beats an earlier one (0 where the orders agree;
  near-equal scores may come out in either order);
- `box_gap_m`, `prob_gap`: the reference then runs the decoder on the
  program's order (admissible by the above) and every query's corners
  (metres) and class and objectness probabilities are compared;
- `keep_mismatch`: the keep mask against the reference's empty-box
  counts and NMS loop on the program's own boxes: exact.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
LEAF_FLOOR = 1e-3  # leaves under this share of the median gradient norm
TRAIN_NUMBERS = ("loss1_gap", "loss_gap", "grad_gap", "grad_median_gap",
                 "delta_gap", "delta_median_gap", "order_gap",
                 "assign_excess", "class_gap")
EVAL_NUMBERS = ("order_gap", "box_gap_m", "prob_gap", "keep_mismatch")


def limits(cell: str) -> Dict[str, float]:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def judge(readings: Dict[str, float], lim: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number the limits name
    within its limit, and none missing; the other readings are notes."""
    checks = {k: {"value": readings.get(k), "limit": v}
              for k, v in lim.items() if not k.startswith("_")}
    ok = all(c["value"] is not None and np.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def leaf_norms(tensors: Dict[str, torch.Tensor], names: List[str]):
    return torch.stack([torch.linalg.vector_norm(tensors[n].float())
                        for n in names]).cpu().numpy().astype(np.float64)


def _leaf_gaps(prog: np.ndarray, ref: np.ndarray, keep: np.ndarray):
    """Each kept leaf's |n_p - n_r| / max(n_r, the median leaf's n_r)."""
    scale = np.maximum(ref, np.median(ref[keep]))
    return np.where(keep, np.abs(prog - ref) / scale, np.nan)


def train_readings(prog: dict, ref: dict, names: List[str]) -> dict:
    """prog/ref: {"losses": [...], "grad": leaf norms, "delta": leaf
    norms} in `names` order. Every reading the limits may name: the loss
    of the first step and of all (`loss1_gap`, `loss_gap`), the worst and
    the median leaf of the first gradient and of the change
    (`grad_gap`, `grad_median_gap`, `delta_gap`, `delta_median_gap`), and
    notes: the losses and the five worst leaves of each; with them the
    reference's judgment of the program's decisions (`order_gap`,
    `assign_excess`, `class_gap`). A reference that could not follow the
    program (None, or other parameters) reads inf everywhere."""
    if ref is None or ref["names"] != names:
        return {k: float("inf") for k in TRAIN_NUMBERS}
    lp, lr = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    keep = ref["grad"] >= LEAF_FLOOR * np.median(ref["grad"])
    out = {
        "loss1_gap": float(abs(lp[0] - lr[0]) / abs(lr[0])),
        "loss_gap": float(np.max(np.abs(lp - lr) / np.abs(lr))),
        "_losses_program": lp.tolist(),
        "_losses_reference": lr.tolist(),
        "_leaves_left_out": [n for n, k in zip(names, keep) if not k],
        "order_gap": ref.get("order_gap", 0.0),
        "assign_excess": ref.get("assign_excess", 0.0),
        "class_gap": ref.get("class_gap", 0.0),
    }
    for key in ("grad", "delta"):
        gaps = _leaf_gaps(prog[key], ref[key], keep)
        out[f"{key}_gap"] = float(np.nanmax(gaps))
        out[f"{key}_median_gap"] = float(np.nanmedian(gaps))
        worst = np.argsort(np.nan_to_num(gaps, nan=-1.0))[::-1][:5]
        out[f"_{key}_worst_leaves"] = [[names[i], float(gaps[i])]
                                       for i in worst]
    return out


def decisions_fit(decisions, batches, nq: int) -> bool:
    """Whether the recorded decisions are one a step, each choice of
    proposals (B, nq), each prediction's angle classes and the seeds'
    size-prior classes (B, n) for its batch. A decision the program did not record (a key left out) the
    reference takes itself."""
    if decisions is None or len(decisions) != len(batches):
        return False
    for d, b in zip(decisions, batches):
        B = b["point_clouds"].shape[0]
        if "topk" in d and tuple(d["topk"].shape) != (B, nq):
            return False
        if any(c.shape[0] != B for c in d.get("angle_cls", ())):
            return False
        if "size_cls" in d and d["size_cls"].shape[0] != B:
            return False
    return True


def reference_train(conf, traffic, seed, batches, device, tf32=False,
                    half_batch=False, decisions=None):
    """The reference's readings of the first steps: {"losses", "grad",
    "delta", "names", "decisions" (those it took), "order_gap",
    "assign_excess", "class_gap"}. `decisions` (the program's, one a
    step): the reference takes the program's choice of proposals,
    assignments, angle classes and size-prior classes, and judges them: `order_gap`, the
    largest score by which the choice inverts the reference's layer-0
    scores (`_order_gap`), `assign_excess`, the assignments' cost over
    the reference matcher's own in units of the auction's
    eps-optimality, and `class_gap`, the largest logit by which another
    class beats an angle or size-prior class taken. Decisions
    that do not fit the batches give None. `tf32`: the matmuls in TF32 (the
    control); `half_batch`: each step on the first half of its batch."""
    from benchmark import weights as W
    from benchmark.reference import steps as R

    cfg = R.ref_config(conf)
    if decisions is not None and not decisions_fit(decisions, batches,
                                                   cfg.nqueries):
        return None
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        cfg, model, criterion = R.build(conf, device)
        w = W.for_cell(model, conf, traffic, seed, device)
        W.load(model, w)
        del w
        names = [n for n, _ in model.named_parameters()]
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        if half_batch:
            batches = [{k: v[:v.shape[0] // 2] for k, v in b.items()}
                       for b in batches]
        r = R.train_steps(cfg, model, criterion, batches,
                          dropout_generator(seed, device),
                          conf["steps_per_epoch"], decisions)
        delta = {n: r["params"][n] - p0[n] for n in names}
        order = [float(_order_gap(s, d["topk"], v).max())
                 for (s, v), d in zip(r["scores"], r["decisions"])]
        return {"losses": r["losses"],
                "grad": leaf_norms(r["first_grads"], names),
                "delta": leaf_norms(delta, names), "names": names,
                "decisions": r["decisions"], "order_gap": max(order),
                "assign_excess": max(r["assign_excess"]),
                "class_gap": max(r["class_margin"])}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def dropout_generator(seed: int, device) -> torch.Generator:
    from benchmark.weights import derived_seed

    return torch.Generator(device=device).manual_seed(derived_seed(seed, 2))


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------

def _proposals_of(program_centers, proposal_centers, proposal_valid):
    """(B, nq) index of the proposal nearest each program query's centre,
    and (B,) whether every query found a distinct one."""
    d = torch.cdist(program_centers, proposal_centers)
    d = torch.where(proposal_valid[:, None, :], d, torch.inf)
    idx = d.argmin(dim=2)
    distinct = torch.tensor([len(torch.unique(r)) == r.numel() for r in idx],
                            device=idx.device)
    return idx, distinct


def _order_gap(scores, order, valid):
    """The largest score by which a later entry of `order` (B, nq), or a
    valid proposal outside it, beats an earlier entry."""
    s = scores.gather(1, order)
    prefix_min = torch.cummin(s, dim=1).values
    inv = (s[:, 1:] - prefix_min[:, :-1]).clamp(min=0).amax(dim=1)
    chosen = torch.zeros_like(valid).scatter_(1, order, True)
    left = torch.where(valid & ~chosen, scores, -torch.inf).amax(dim=1)
    out = (left - s.amin(dim=1)).clamp(min=0)
    return torch.maximum(inv, out)


@torch.no_grad()
def eval_readings(conf, cfg, model, batch, prog_out: Dict[str, np.ndarray],
                  device) -> dict:
    """The numbers of one sampled batch: the reference `model` (weights
    loaded) judges the program's outputs `prog_out`."""
    from benchmark.reference import steps as R

    p = {k: torch.from_numpy(v).to(device) for k, v in prog_out.items()}
    enc_xyz, seed_valid, scores, ref_order = R.proposals(model, batch)
    B, nq = ref_order.shape
    want = {"center_unnormalized": (B, nq, 3), "box_corners": (B, nq, 8, 3),
            "sem_cls_prob": (B, nq, cfg.num_semcls),
            "objectness_prob": (B, nq), "nms_keep": (B, nq)}
    if any(k not in p or tuple(p[k].shape) != s for k, s in want.items()):
        return unreadable_eval(B)
    idx, distinct = _proposals_of(p["center_unnormalized"], enc_xyz,
                                  seed_valid)
    order_gap = _order_gap(scores, idx, seed_valid)
    order_gap = torch.where(distinct, order_gap, torch.inf)
    r = R.eval_step(cfg, model, batch, topk=idx, keep=False)
    box_gap = (p["box_corners"] - r["box_corners"]).abs().amax(
        dim=(1, 2, 3))
    prob_gap = torch.maximum(
        (p["sem_cls_prob"] - r["sem_cls_prob"]).abs().amax(dim=(1, 2)),
        (p["objectness_prob"] - r["objectness_prob"]).abs().amax(dim=1))
    judged = R.nms_keep(cfg, {k: v for k, v in p.items() if k != "nms_keep"},
                        batch["point_clouds"])
    keep_mismatch = (judged != p["nms_keep"]).sum(dim=1)
    same_order = (idx == ref_order).all(dim=1)
    return {
        "order_gap": order_gap.cpu().numpy(),
        "box_gap_m": box_gap.cpu().numpy(),
        "prob_gap": prob_gap.cpu().numpy(),
        "keep_mismatch": keep_mismatch.cpu().numpy().astype(np.float64),
        "_order_as_reference": same_order.cpu().numpy(),
        "_swapped_queries": (idx != ref_order).sum(dim=1).cpu().numpy(),
    }


def unreadable_eval(B: int = 1) -> dict:
    """The readings of B scenes whose answers are missing or malformed."""
    inf = np.full(B, np.inf)
    return {k: inf for k in EVAL_NUMBERS} | {
        "_order_as_reference": np.zeros(B), "_swapped_queries": inf}


def merge_eval(parts: List[dict]) -> dict:
    """The worst of each number over the sampled batches' scenes; of the
    notes ("_" keys), the sum."""
    out = {}
    for k in parts[0]:
        v = np.concatenate([np.atleast_1d(p[k]) for p in parts])
        out[k] = float(v.sum() if k.startswith("_") else v.max())
    return out
