"""Rank bodies of the port's key-sharding tests
(tests/test_torch_seq_attention.py, tests/test_torch_seq_model.py).

The ranks are spawned processes (`vdetr_tpu_torch.tools.run_ranks`), which
unpickle their target by module: this module imports no jax, so a rank
starts with torch and the port alone. Each rank runs torch on one thread
and meets the others over gloo. Inputs arrive as numpy arrays in the
spec; results go back as CPU tensors and plain values.
"""

import numpy as np
import torch

from vdetr_tpu_torch.parallel import dist


def _join(rank: int, spec: dict):
    torch.set_num_threads(1)
    return dist.init(rank, spec["world"], spec["init_method"], "gloo",
                     timeout=spec["timeout"])


def _t(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(grad)


def attention_rank(rank: int, spec: dict) -> dict:
    """One rank of a seq group of `world`: the port's
    `parallel/seq_attention.py` functions and the sharded RPE attention
    on this rank's key shard of the spec's arrays, with the gradients of
    a fixed weighting of each output."""
    from vdetr_tpu_torch.ops.rpe_attention import sharded_rpe_cross_attention
    from vdetr_tpu_torch.parallel.seq_attention import (
        combine_sharded_logits, gather_selected_sharded, global_topk_sharded,
        make_sharded_rpe_cross_attention, sharded_softmax_attention)

    group = _join(rank, spec)
    try:
        S = spec["world"]
        a = spec["arrays"]
        sl = dist.rows(a["k"].shape[1], rank, S)
        out = {}

        q = _t(a["q"], True)
        k, v = _t(a["k"][:, sl], True), _t(a["v"][:, sl], True)
        bias = _t(a["bias"][..., sl], True)
        valid = _t(a["valid"][:, sl])
        o = sharded_softmax_attention(q, k, v, bias, valid, group)
        grads = torch.autograd.grad((o * _t(a["w_out"])).sum(),
                                    (q, k, v, bias))
        out["softmax"] = (o.detach(), [g.detach() for g in grads])
        o = sharded_softmax_attention(q, k, v, bias, _t(a["valid_shard0"]
                                                        [:, sl]), group)
        out["softmax_masked_shard"] = o.detach()

        logits = _t(a["logits"][..., sl], True)
        o = combine_sharded_logits(logits, v, group)
        grads = torch.autograd.grad((o * _t(a["w_out"])).sum(), (logits, v))
        out["combine"] = (o.detach(), [g.detach() for g in grads])

        idx, off = global_topk_sharded(_t(a["scores"][:, sl]), spec["nq"],
                                       group)
        out["topk"] = (idx, off)
        x = _t(a["rows"][:, sl], True)
        g = gather_selected_sharded(x, _t(a["global_idx"]), off, group)
        out["gather"] = (g.detach(), torch.autograd.grad(
            (g * _t(a["w_rows"])).sum(), x)[0])

        def bias_fn(ref, kxyz):
            d = ref[:, None, :, None, :] - kxyz[:, None, None, :, :]
            return -(d * d).sum(-1).expand(-1, q.shape[1], -1, -1)

        attend = make_sharded_rpe_cross_attention(bias_fn, group)
        out["rpe_attend"] = attend(
            q, k, v, _t(a["ref"]), _t(a["kxyz"][:, sl]), valid).detach()

        # the sharded RPE attention (kernel C and F's plain versions here)
        r = spec["rpe"]
        ks = dist.rows(r["k"].shape[1], rank, S)
        res = {}
        for rate in (0.0, 0.1):
            t = [_t(r[n], True) for n in ("q",)] + [
                _t(r[n][:, ks], True) for n in ("k", "v")] + [
                _t(r["tables"], True)]
            o = sharded_rpe_cross_attention(
                t[0], t[1], t[2], _t(r["corners"]), _t(r["angles"]),
                _t(r["key_xyz"][:, ks]), t[3], _t(r["key_valid"][:, ks]),
                group=group, key_offset=ks.start, log_scale=512.0,
                max_value=4.0, rotate=True, dropout_rate=rate,
                seed=torch.tensor([r["seed"]]))
            grads = torch.autograd.grad((o * _t(r["w"])).sum(), t)
            with torch.no_grad():
                ev = sharded_rpe_cross_attention(
                    t[0], t[1], t[2], _t(r["corners"]), _t(r["angles"]),
                    _t(r["key_xyz"][:, ks]), t[3],
                    _t(r["key_valid"][:, ks]), group=group,
                    key_offset=ks.start, log_scale=512.0, max_value=4.0,
                    rotate=True, dropout_rate=rate,
                    seed=torch.tensor([r["seed"]]))
            res[rate] = (o.detach(), [g.detach() for g in grads], ev)
        out["rpe"] = res
        return out
    finally:
        dist.destroy(group)


def _model(cfg, state):
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.models.vdetr import build_model

    model = build_model(cfg, ScannetDatasetConfig(), device="cpu")
    model.load_state_dict(torch.load(state, weights_only=True))
    return model


def seq_model_rank(rank: int, spec: dict) -> dict:
    """Rank (d, s) of a (data, seq) grid (`spec["cfg"]`'s mesh) on the
    CPU: the decoder alone on the seeds of its shard (`decoder`), the
    eval step of `eval_cfg`, and a train step of `cfg` on its rows and
    point block of `batch`, each from the weights at `state`. Returns
    their outputs, and after the step the loss, the loss dict, the
    train-mode outputs, every gradient, parameter and buffer."""
    from vdetr_tpu_torch.data.dataset_config import ScannetDatasetConfig
    from vdetr_tpu_torch.data.loader import seq_block
    from vdetr_tpu_torch.train.engine import Trainer, epoch_generator

    group = _join(rank, spec)
    try:
        ds = ScannetDatasetConfig()
        cfg = spec["cfg"]
        out = {}
        trainer = Trainer(spec["eval_cfg"], _model(spec["eval_cfg"],
                                                   spec["state"]),
                          ds, 1, device="cpu", group=group)
        g = trainer.grid
        batch = seq_block({k: v[dist.rows(len(v), g.d, g.D)]
                           for k, v in spec["batch"].items()}, g.s, g.S)
        out["grid"] = (g.D, g.S, g.d, g.s)
        out["eval"] = {k: v.clone() for k, v in
                       trainer.eval_step(batch).items()}

        dec = spec["decoder"]
        model = trainer.model
        sl = dist.rows(dec["feats"].shape[1], g.s, g.S)
        with torch.no_grad():
            d_out = model.decoder(
                _t(dec["feats"][:, sl]), _t(dec["xyz"][:, sl]),
                [_t(dec["dmin"]), _t(dec["dmax"])],
                {k: _t(v[:, sl]) for k, v in dec["enc_pred"].items()},
                enc_valid=_t(dec["valid"][:, sl]))
        out["decoder"] = d_out

        trainer = Trainer(cfg, _model(cfg, spec["state"]), ds, 1,
                          device="cpu", group=group)
        seen = {}
        criterion = trainer.criterion

        def recording(outputs, targets):
            seen.update({k: outputs["outputs"][k].detach().clone()
                         for k in spec["output_keys"]})
            return criterion(outputs, targets)

        trainer.criterion = recording
        loss, parts = trainer.train_step(batch, epoch_generator(trainer, 0))
        model = trainer.model
        out["train"] = {
            "loss": loss, "parts": {k: float(v) for k, v in parts.items()},
            "outputs": seen,
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "buffers": {n: b.detach().clone()
                        for n, b in model.named_buffers()}}
        dist.barrier(group)
        return out
    finally:
        dist.destroy(group)
