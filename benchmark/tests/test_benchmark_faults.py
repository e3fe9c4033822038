"""A run whose timed path is broken underneath comes out not correct:
the rest of a run (set-up, window, check) is driven on the CPU, with the
cell's own limits, and the program's step replaced by a faulty one, once
for each fault the cell can have. (The look for a chip is the only part
of a run skipped.)"""

import pytest
import torch

from benchmark import check, harness
from tiny import tiny_cell


def _half(batch):
    return {k: v[:v.shape[0] // 2] for k, v in batch.items()}


def _unchanged(trainer, batch, gen):
    """A step that returns its state unchanged: the loss is computed, the
    parameters and the optimizer are left as they were."""
    params = [p.detach().clone() for p in trainer.model.parameters()]
    state = {k: {kk: vv.clone() if torch.is_tensor(vv) else vv
                 for kk, vv in v.items()}
             for k, v in trainer.optimizer.state.items()}
    loss = trainer.train_step(batch, gen)
    with torch.no_grad():
        for p, q in zip(trainer.model.parameters(), params):
            p.copy_(q)
    trainer.optimizer.state.clear()
    trainer.optimizer.state.update(state)
    return loss


def _altered(trainer, batch):
    out = {k: v.clone() for k, v in trainer.eval_step(batch).items()}
    out["center_unnormalized"][0, 0, 0] += 0.05
    out["box_corners"][0, 0, :, 0] += 0.05
    return out


TRAIN_FAULTS = {
    "unchanged_state": {"train_step": _unchanged},
    "half_batch": {"train_step": lambda tr, b, g: tr.train_step(_half(b), g)},
}
FAULTS = {
    "scannet_r34.train_b8": TRAIN_FAULTS,
    "sunrgbd_r34.train_b8": TRAIN_FAULTS,
    "scannet_r34.eval_b8": {
        "half_batch": {"eval_step": lambda tr, b: tr.eval_step(_half(b))},
        "answer_altered": {"eval_step": _altered},
    },
}
CASES = [(w, f) for w, faults in FAULTS.items() for f in faults]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault):
    cell = tiny_cell(workload)
    res = harness.execute(cell, 23, 0.5, False, "cpu",
                          check.limits(workload),
                          hooks=FAULTS[workload][fault])
    assert res["correct"] is False, res["checks"]
