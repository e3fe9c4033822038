"""Does a train step repeat bit for bit? Where does it not, and why?

    python -m vdetr_tpu_torch.tools.determinism [--routes keyed,mapped]

On the card, for each conv route, the published model (`VDETRConfig()`,
the auction matcher on kernel M, seeded random weights, dropout on) and one
synthetic scene at batch 1:
- `grad_spread`: two forwards and backwards from one state, batch and
  dropout seed; per parameter max |g1 - g2| / max |g1|, by group (the
  name's first component) and by the parameter tensors that differ, in
  the model's order (a nonzero parameter nearest the loss, in backward
  order, points at the sum that is not fixed);
- the same under `torch.use_deterministic_algorithms(True,
  warn_only=True)`, with the op named by each warning it raised: the ops
  of the step that have no deterministic form. The spread with the flag
  on says whether the torch ops' deterministic forms remove it (then the
  source is a torch op) or not (then it is one of the port's kernels).
  The flag is set here only, for that run, and put back: the library
  never sets it;
- `step_twice`: two whole train steps (clip and AdamW included) from one
  state, batch and seed; the parameters that are not bit-equal after.
Prints one JSON line (`determinism {...}`) and the card. Needs the card.
"""

from __future__ import annotations

import argparse
import copy
import json
import re
import sys
import warnings

import torch

SEED = 0


def _inputs(trainer, batch):
    from vdetr_tpu_torch.train.engine import INPUT_KEYS

    b = trainer._to_device(batch)
    return b, {k: b[k] for k in INPUT_KEYS if k in b}


def backward_grads(trainer, batch, seed: int = SEED):
    """The parameters' gradients of one forward, criterion and backward on
    `batch` with dropout drawn from `seed`; the norms' running buffers put
    back afterwards, so the model's state is as it was."""
    model, crit = trainer.model, trainer.criterion
    b, inputs = _inputs(trainer, batch)
    buffers = {n: x.clone() for n, x in model.named_buffers()}
    model.train()
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=b["point_clouds"].device).manual_seed(seed)
    loss, _ = crit(model(inputs, generator=gen), b)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        for n, x in model.named_buffers():
            x.copy_(buffers[n])
    return grads


def spread_of(g1, g2):
    """{"groups": {group: {max_abs_diff, max_abs, rel}}, "differing":
    [(name, rel)] in the model's order}: per parameter max |g1 - g2|
    over max |g1|, by the name's first component."""
    groups, differing = {}, []
    for n, a in g1.items():
        d = float((g2[n] - a).abs().max())
        top = float(a.abs().max())
        if d > 0 or not torch.equal(a, g2[n]):
            differing.append((n, d / top if top > 0 else float("inf")))
        gd, gt = groups.get(n.split(".")[0], (0.0, 0.0))
        groups[n.split(".")[0]] = (max(gd, d), max(gt, top))
    return {"groups": {k: {"max_abs_diff": d, "max_abs": t,
                           "rel": d / t if t > 0 else 0.0}
                       for k, (d, t) in sorted(groups.items())},
            "differing": differing}


def grad_spread(trainer, batch, seed: int = SEED):
    """Two backwards from one state, batch and dropout seed (see
    `backward_grads`) and their spread (`spread_of`)."""
    return spread_of(backward_grads(trainer, batch, seed),
                     backward_grads(trainer, batch, seed))


_OP = re.compile(r"^(\S+) does not have a deterministic implementation")


def deterministic_flag_run(trainer, batch, seed: int = SEED):
    """`grad_spread` under torch.use_deterministic_algorithms(True,
    warn_only=True); returns (spread, {op: count}) with the op that each
    warning names (the warning's text where it names none). The flag is
    restored on the way out."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    ops = {}
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            spread = grad_spread(trainer, batch, seed)
        for w in caught:
            text = str(w.message)
            m = _OP.match(text)
            key = m.group(1) if m else text[:160]
            ops[key] = ops.get(key, 0) + 1
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    return spread, ops


def step_twice(trainer, batch, seed: int = SEED):
    """Two whole train steps (forward, criterion, backward, clip, AdamW)
    from one state: a deep copy of the trainer takes the second. Returns
    the names of the parameters that are not bit-equal afterwards (empty:
    the step repeats bit for bit) and the number compared."""
    other = copy.deepcopy(trainer)
    dev = trainer.device
    for tr in (trainer, other):
        tr.train_step(batch, torch.Generator(device=dev).manual_seed(seed))
    mine = dict(trainer.model.named_parameters())
    theirs = dict(other.model.named_parameters())
    differ = [n for n, p in mine.items() if not torch.equal(p, theirs[n])]
    del other
    return differ, len(mine)


def run(routes, device) -> dict:
    from vdetr_tpu_torch.config import VDETRConfig
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.data.synthetic import (SyntheticDetectionDataset,
                                                collate)
    from vdetr_tpu_torch.models.vdetr import build_model
    from vdetr_tpu_torch.train.engine import Trainer

    cfg = VDETRConfig()
    ds = ScannetDatasetConfig()
    data = SyntheticDetectionDataset(ds, cfg.num_points, seed=SEED)
    batch = collate([data[1]])
    out = {}
    for route in routes:
        model = build_model(cfg, ds, generator=torch.Generator().manual_seed(
            SEED), device=device, conv_route=route)
        trainer = Trainer(cfg, model, ds, steps_per_epoch=1000, device=device)
        trainer.train_step(collate([data[0]]),
                           torch.Generator(device=device).manual_seed(SEED))
        plain = grad_spread(trainer, batch)
        flagged, ops = deterministic_flag_run(trainer, batch)
        differ, count = step_twice(trainer, batch)
        out[route] = {"grad_spread": plain, "grad_spread_flag_on": flagged,
                      "nondeterministic_ops": ops,
                      "step_twice_differing": differ,
                      "step_twice_compared": count}
        del trainer, model
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--routes", default="keyed,mapped")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("determinism: no CUDA device")
    from vdetr_tpu_torch.tools import card

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = run(args.routes.split(","), torch.device("cuda", 0))
    for route, r in res.items():
        for key in ("grad_spread", "grad_spread_flag_on"):
            s = r[key]
            print(f"{route} {key}: " + "; ".join(
                f"{k} {v['rel']:.2e}" for k, v in s["groups"].items()))
            print(f"  parameters that differ ({len(s['differing'])}), in "
                  "the model's order: " + ", ".join(
                      f"{n} {rel:.1e}" for n, rel in s["differing"][:60]))
        print(f"{route} ops without a deterministic form (warnings under "
              f"the flag): {r['nondeterministic_ops']}")
        print(f"{route} two whole steps from one state: "
              f"{len(r['step_twice_differing'])} of "
              f"{r['step_twice_compared']} parameters differ: "
              f"{r['step_twice_differing'][:20]}")
    print("determinism " + json.dumps(res))
    print(f"card: {card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
