"""The control comes out not correct: the reference computed with TF32
matmuls (the precision below the configurations' float32) put in the
program's place, judged against the reference in float32 by each cell's
own limits, on three seeds. On the card only (TF32 is a tensor-core
mode); at the tiny size, so that a test run holds it. The cells' own
size is measured by `python3 -m benchmark.calibrate` (PERF.md)."""

import pytest

from benchmark import calibrate, check
from tiny import tiny_cell

pytestmark = pytest.mark.cuda
SEEDS = (3000000001, 3000000002, 3000000003)


@pytest.mark.parametrize("workload", ["scannet_r34.train_b8",
                                      "scannet_r34.eval_b8",
                                      "sunrgbd_r34.train_b8"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(card, workload, seed):
    cell = tiny_cell(workload)
    fn = (calibrate.train_seed if cell["traffic"]["step"] == "train"
          else calibrate.eval_seed)
    out = fn(cell, seed, card, control=True, faults=())
    ok, checks = check.judge(out["control"], check.limits(workload))
    assert not ok, checks
