"""The plain reference agrees with the port's CPU path on a tiny
configuration: the eval step's outputs and keep mask, and a train step's
loss, gradients and parameters."""

import numpy as np
import pytest
import torch

from benchmark import check, harness, weights as W
from benchmark.reference import steps as R
from tiny import tiny_cell

DEV = torch.device("cpu")


@pytest.mark.parametrize("workload", ["scannet_r34.eval_b8"])
def test_eval_step_matches_the_port(workload):
    cell = tiny_cell(workload)
    s = harness.set_up(cell, 17, DEV)
    batch = s.feed[0]
    prog = {k: v.numpy() for k, v in s.eval_step(s.trainer, batch).items()}
    cfg, model, _ = R.build(cell["config"], DEV)
    W.load(model, W.for_cell(model, cell["config"], cell["traffic"], 17,
                             DEV))
    ref = R.eval_step(cfg, model, batch)
    for k, v in ref.items():
        np.testing.assert_allclose(prog[k], v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    r = check.eval_readings(cell["config"], cfg, model, batch, prog, DEV)
    assert r["order_gap"].max() == 0 and r["keep_mismatch"].max() == 0
    assert r["box_gap_m"].max() < 1e-5 and r["prob_gap"].max() < 1e-5


@pytest.mark.parametrize("workload", ["scannet_r34.train_b8",
                                      "sunrgbd_r34.train_b8"])
def test_first_train_step_matches_the_port(workload):
    cell = tiny_cell(workload, check_steps=1)
    s = harness.set_up(cell, 19, DEV)
    ref = check.reference_train(cell["config"], cell["traffic"], 19,
                                [s.feed[0]], DEV)
    assert ref["names"] == s.names
    r = check.train_readings(s.prog_read, ref, ref["names"])
    assert r["loss_gap"] < 1e-5
    assert r["grad_gap"] < 1e-4 and r["delta_gap"] < 1e-3


def test_classes_are_read_from_the_decoder():
    """The recorder reads each box's angle class back from the program's
    angle and residual, and each seed's size-prior class from its prior:
    the argmaxes the program took, on every box and seed."""
    from benchmark import program

    cell = tiny_cell("sunrgbd_r34.train_b8", check_steps=1)
    s = harness.set_up(cell, 29, DEV)
    seen = []
    hook = s.trainer.model.decoder.register_forward_hook(
        lambda m, a, out: seen.append((a, out)))
    with program.record_decisions(
            s.trainer.model,
            cell["config"]["dataset_config"]["mean_size_arr"]) as rec:
        rec.append({})
        s.trainer.train_step(s.feed[1], s.gen)
    hook.remove()
    args, out = seen[0]
    preds = list(out["aux_outputs"]) + [out["outputs"]]
    classes = rec[0]["angle_cls"]
    assert len(classes) == len(preds) and "topk" in rec[0]
    for c, p in zip(classes, preds):
        torch.testing.assert_close(
            c, torch.softmax(p["angle_logits"], -1).argmax(-1), rtol=0,
            atol=0)
    enc = next(a for a in args if isinstance(a, dict))
    torch.testing.assert_close(
        rec[0]["size_cls"],
        torch.sigmoid(enc["point_cls_logits"]).argmax(-1), rtol=0, atol=0)


@pytest.mark.parametrize("key", ["angle_cls", "size_cls"])
def test_reference_judges_the_classes(key):
    """Following the program's classes reads `class_gap` at rounding;
    angle or size-prior classes moved by one read a gap of whole
    logits."""
    cell = tiny_cell("sunrgbd_r34.train_b8", check_steps=1)
    s = harness.set_up(cell, 31, DEV)
    batches = [s.feed[0]]
    assert key in s.decisions[0]
    ref = check.reference_train(cell["config"], cell["traffic"], 31,
                                batches, DEV, decisions=s.decisions)
    assert ref["class_gap"] < 1e-4
    ds = cell["config"]["dataset_config"]
    n = ds["num_angle_bin"] if key == "angle_cls" else ds["num_semcls"]

    def moved(c):
        return [(x + 1) % n for x in c] if key == "angle_cls" else (c + 1) % n

    bad = check.reference_train(
        cell["config"], cell["traffic"], 31, batches, DEV,
        decisions=[dict(d, **{key: moved(d[key])}) for d in s.decisions])
    assert bad["class_gap"] > 100 * max(ref["class_gap"], 1e-6)
