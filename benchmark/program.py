"""The system under test: `vdetr_tpu_torch`'s `Trainer` built from a
configuration file, with the benchmark's weights. This is the one module
of the harness that imports the program."""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from benchmark import weights as W


def program_config(conf: dict, traffic: dict):
    from vdetr_tpu_torch.config import VDETRConfig

    fields = dict(conf["model"])
    for k in ("grid_extent", "mesh_shape", "mesh_axis_names"):
        fields[k] = tuple(fields[k])
    if traffic["step"] == "eval":
        fields["test_only"] = True
    return VDETRConfig(**fields).validate()


def build_trainer(conf: dict, traffic: dict, seed: int, device):
    """(trainer, weights): the published model on the keyed route with
    the run's weights, and a `Trainer` of the configuration's steps per
    epoch. The program's dataset config is its own, checked against the
    configuration file's."""
    from vdetr_tpu_torch.data.dataset_config import get_dataset_config
    from vdetr_tpu_torch.models.vdetr import VDETR
    from vdetr_tpu_torch.train.engine import Trainer

    cfg = program_config(conf, traffic)
    dsc = conf["dataset_config"]
    ds = get_dataset_config(dsc["name"])
    if (ds.num_semcls, ds.num_angle_bin) != (dsc["num_semcls"],
                                             dsc["num_angle_bin"]) or \
            not np.allclose(ds.mean_size_arr, dsc["mean_size_arr"]):
        raise ValueError("the program's dataset config differs from "
                         f"{conf['name']}'s")
    with torch.device(device):
        model = VDETR(cfg, ds.num_semcls, ds.num_angle_bin,
                      ds.mean_size_arr, conv_route="keyed")
    w = W.for_cell(model, conf, traffic, seed, device)
    W.load(model, w)
    trainer = Trainer(cfg, model, ds, conf["steps_per_epoch"], device=device)
    return trainer, w


@contextmanager
def record_decisions(model, mean_size):
    """The program's discrete decisions while the context is open, one
    entry per train step (the caller appends a dict before each):
    "topk", the decoder's choice of proposals (`models/transformer.py:
    select_proposals`), "assign", the matcher's assignments of every job
    (`SetCriterion.solve_costs`), and, read by a forward hook on `model`'s
    decoder, "angle_cls", the angle class that each box of each
    prediction took (`taken_angle_classes`), and "size_cls", the class
    whose mean size (a row of `mean_size`) each seed's size prior took
    (`taken_size_classes`). A decision the
    program does not offer is left out, and the reference takes it
    itself. The reference follows them once it has judged them
    (`check.py`). Used in set-up's first steps only, never in the
    measured window."""
    from vdetr_tpu_torch.models import transformer
    from vdetr_tpu_torch.train import criterion

    rec = []
    select0 = getattr(transformer, "select_proposals", None)
    solve0 = getattr(criterion.SetCriterion, "solve_costs", None)

    def select(obj, nq):
        out = select0(obj, nq)
        rec[-1]["topk"] = out.detach().clone()
        return out

    def solve(self, *args, **kw):
        out = solve0(self, *args, **kw)
        rec[-1]["assign"] = [{k: v.detach().clone() for k, v in job.items()}
                             for job in out]
        return out

    def on_decoder(module, args, kwargs, out):
        classes = taken_angle_classes(out)
        if classes is not None:
            rec[-1]["angle_cls"] = classes
        sizes = taken_size_classes(list(args) + list(kwargs.values()),
                                   mean_size)
        if sizes is not None:
            rec[-1]["size_cls"] = sizes

    decoder = getattr(model, "decoder", None)
    hook = (decoder.register_forward_hook(on_decoder, with_kwargs=True)
            if decoder is not None else None)
    if select0 is not None:
        transformer.select_proposals = select
    if solve0 is not None:
        criterion.SetCriterion.solve_costs = solve
    try:
        yield rec
    finally:
        if hook is not None:
            hook.remove()
        if select0 is not None:
            transformer.select_proposals = select0
        if solve0 is not None:
            criterion.SetCriterion.solve_costs = solve0


ANGLE_MATCH = 1e-5  # radians: a box's angle from its class and residual
SIZE_MATCH = 1e-6  # metres: a size prior from its class's mean size


@torch.no_grad()
def taken_size_classes(decoder_inputs, mean_size):
    """(B, n_seeds): the class whose mean size each seed's size prior
    ("size_unnormalized" of the encoder's box predictions, one of the
    decoder's inputs) is. None where the priors are no class's mean size
    (hard anchors: every prior is 1 m) or the input is not found."""
    for x in decoder_inputs:
        if isinstance(x, dict) and "size_unnormalized" in x:
            size = x["size_unnormalized"].detach()
            rows = torch.tensor(mean_size, dtype=size.dtype,
                                device=size.device)
            diff = (size[..., None, :] - rows).abs().amax(dim=-1)
            best = diff.min(dim=-1)
            if float(best.values.max()) > SIZE_MATCH:
                return None
            return best.indices
    return None


@torch.no_grad()
def taken_angle_classes(out):
    """The angle class of each box of each prediction (layer 0 first) in
    the decoder's outputs `out`: the bin whose centre plus residual gives
    the box's angle. None where the boxes have one angle bin, or where an
    angle matches no bin (the outputs are not read as they were)."""
    try:
        preds = list(out["aux_outputs"]) + [out["outputs"]]
        if preds[0]["angle_logits"].shape[-1] == 1:
            return None
        classes = []
        for p in preds:
            res = p["angle_residual"].detach()
            n = res.shape[-1]
            bins = torch.arange(n, device=res.device)
            cand = 2 * np.pi / n * bins + res
            cand = torch.where(cand > np.pi, cand - 2 * np.pi, cand)
            diff = (cand - p["angle_continuous"].detach()[..., None]).abs()
            best = diff.min(dim=-1)
            if float(best.values.max()) > ANGLE_MATCH:
                return None
            classes.append(best.indices)
        return classes
    except (KeyError, TypeError, AttributeError, IndexError):
        return None
