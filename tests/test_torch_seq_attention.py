"""Key-sharded attention of the port on the CPU (`parallel/seq_attention.py`
and `ops/rpe_attention.py:sharded_rpe_cross_attention`), two ranks in
spawned processes over gloo (`tests/torch_seq_ranks.py:attention_rank`),
started once for the module.

- Each function of `parallel/seq_attention.py` against the JAX package's
  under `shard_map` on 2 of the 8 CPU devices, on the same numpy inputs,
  at `tests/test_seq_model.py`'s atol 2e-4 / rtol 1e-3; their gradients
  (each rank's backward sums the cotangents of every rank's copy of the
  output, so the ranks' gradients of a replicated input add up to 2x the
  dense one's) against the dense function's in torch autograd.
- The sharded RPE attention (kernel C on each shard with the shards
  merged by their log-sum-exps, kernel F per shard from the global out
  and lse; their plain versions here) against the dense plain version,
  forward and backward, at dropout 0 and 0.1 under one seed (the hash
  reads global key indices, so a shard's mask is the dense mask's
  slice), with a shard whose keys are all masked in one batch row; the
  eval form (no logits) equal to the train form.
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from torch_seq_ranks import attention_rank
from vdetr_tpu.parallel import make_mesh
from vdetr_tpu.parallel import seq_attention as jsa
from vdetr_tpu_torch.ops.rpe_attention import (dropout_keep,
                                               rpe_cross_attention_ad)
from vdetr_tpu_torch.tools import run_ranks
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

S = 2
ATOL, RTOL = 2e-4, 1e-3
B, H, NQ, NK, HD = 2, 4, 8, 64, 16
NQ_TOP = 12


def _arrays():
    rng = np.random.RandomState(3)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    valid = np.ones((B, NK), bool)
    valid[:, -10:] = False
    valid_shard0 = valid.copy()
    valid_shard0[0, :NK // S] = False   # shard 0 fully masked in row 0
    scores = rng.rand(B, NK).astype(np.float32)
    scores[:, [5, 40]] = 1.5            # an exact tie across the shards
    logits = np.where(valid[:, None, None], f(B, H, NQ, NK), -1e9)
    return dict(q=f(B, H, NQ, HD), k=f(B, NK, HD), v=f(B, NK, HD),
                bias=f(B, H, NQ, NK), valid=valid, valid_shard0=valid_shard0,
                w_out=f(B, NQ, H, HD), logits=logits.astype(np.float32),
                scores=scores, rows=f(B, NK, 3, 2),
                global_idx=rng.randint(0, NK, (B, NQ_TOP)),
                w_rows=f(B, NQ_TOP, 3, 2), ref=f(B, NQ, 3),
                kxyz=f(B, NK, 3))


def _rpe_arrays():
    rng = np.random.RandomState(4)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    nk, n = 32, 5
    key_valid = np.ones((B, nk), bool)
    key_valid[0, :nk // S] = False      # row 0: shard 0 has no valid key
    key_valid[1, 7] = False
    return dict(q=f(B, NQ, H, 8), k=f(B, nk, 8), v=f(B, nk, 8),
                corners=(rng.rand(B, NQ, 8, 3) * 2).astype(np.float32),
                angles=rng.rand(B, NQ).astype(np.float32),
                key_xyz=(rng.rand(B, nk, 3) * 2).astype(np.float32),
                tables=f(8, n, n, n, H), key_valid=key_valid,
                w=f(B, NQ, H, 8), seed=1234)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_attn")
    return run_ranks(attention_rank, S, dict(
        world=S, init_method=f"file://{tmp}/rdzv",
        timeout=datetime.timedelta(seconds=120), arrays=_arrays(),
        rpe=_rpe_arrays(), nq=NQ_TOP), 240)


def _jax(fn, in_specs, *args, out_specs=P()):
    mesh = make_mesh(("seq",), (S,), devices=jax.devices()[:S])
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=False))
    return jax.tree.map(np.asarray, f(*[jnp.asarray(a) for a in args]))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def _dense_softmax(q, k, v, bias, valid):
    logits = torch.einsum("bhqd,bkd->bhqk", q, k) + bias
    logits = torch.where(valid[:, None, None], logits, -torch.inf)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkd->bhqd", p, v).permute(0, 2, 1, 3)


def test_sharded_softmax_attention_matches_jax(ranks):
    a = _arrays()
    key = P(None, "seq")
    for name, valid in (("softmax", "valid"),
                        ("softmax_masked_shard", "valid_shard0")):
        want = _jax(lambda q, k, v, b, m: jsa.sharded_softmax_attention(
            q, k, v, b, m, axis_name="seq"),
            (P(), key, key, P(None, None, None, "seq"), key),
            a["q"], a["k"], a["v"], a["bias"], a[valid])
        for r in ranks:
            got = r[name][0] if name == "softmax" else r[name]
            assert np.isfinite(np.asarray(got)).all()
            _close(got, want)


def test_sharded_softmax_attention_gradients(ranks):
    a = _arrays()
    t = [torch.from_numpy(a[n]).requires_grad_() for n in ("q", "k", "v",
                                                          "bias")]
    out = _dense_softmax(*t, torch.from_numpy(a["valid"]))
    want = torch.autograd.grad((out * torch.from_numpy(a["w_out"])).sum(), t)
    dq = sum(r["softmax"][1][0] for r in ranks)
    _close(dq / S, want[0])
    for s, r in enumerate(ranks):
        sl = slice(s * NK // S, (s + 1) * NK // S)
        _close(r["softmax"][1][1] / S, want[1][:, sl])
        _close(r["softmax"][1][2] / S, want[2][:, sl])
        _close(r["softmax"][1][3] / S, want[3][..., sl])


def test_combine_sharded_logits_matches_jax(ranks):
    a = _arrays()
    want = _jax(lambda l, v: jsa.combine_sharded_logits(l, v, "seq"),
                (P(None, None, None, "seq"), P(None, "seq")),
                a["logits"], a["v"])
    for r in ranks:
        _close(r["combine"][0], want)
    logits = torch.from_numpy(a["logits"]).requires_grad_()
    v = torch.from_numpy(a["v"]).requires_grad_()
    out = torch.einsum("bhqk,bkd->bhqd", torch.softmax(logits, -1),
                       v).permute(0, 2, 1, 3)
    gl, gv = torch.autograd.grad((out * torch.from_numpy(a["w_out"])).sum(),
                                 (logits, v))
    for s, r in enumerate(ranks):
        sl = slice(s * NK // S, (s + 1) * NK // S)
        _close(r["combine"][1][0] / S, gl[..., sl])
        _close(r["combine"][1][1] / S, gv[:, sl])


def test_global_topk_and_gather_match_jax(ranks):
    a = _arrays()

    def jax_topk(sc):
        idx, off = jsa.global_topk_sharded(sc, NQ_TOP, "seq")
        return idx, off[None]

    want_idx, want_off = _jax(jax_topk, (P(None, "seq"),), a["scores"],
                              out_specs=(P(), P("seq")))
    for s, r in enumerate(ranks):
        idx, off = r["topk"]
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        assert off == int(want_off[s]) == s * NK // S
    # the tie at global 5 and 40: the lower index first, as lax.top_k
    assert list(want_idx[0, :2]) == [5, 40]

    def jax_gather(x, gidx):
        off = jax.lax.axis_index("seq") * x.shape[1]
        return jsa.gather_selected_sharded(x, gidx, off, "seq")

    want = _jax(jax_gather, (P(None, "seq"), P()), a["rows"],
                a["global_idx"])
    for s, r in enumerate(ranks):
        _close(r["gather"][0], want)
        # each rank's rows get the cotangent of every rank's copy
        sl = slice(s * NK // S, (s + 1) * NK // S)
        want_g = np.zeros_like(a["rows"])
        for b in range(B):
            for j, i in enumerate(a["global_idx"][b]):
                want_g[b, i] += S * a["w_rows"][b, j]
        _close(r["gather"][1], want_g[:, sl])


def test_make_sharded_rpe_cross_attention_matches_jax(ranks):
    a = _arrays()

    def bias_fn(ref, kxyz):
        d = ref[:, None, :, None, :] - kxyz[:, None, None, :, :]
        return jnp.broadcast_to(-(d * d).sum(-1),
                                (B, H, NQ, kxyz.shape[1]))

    want = _jax(lambda q, k, v, ref, kx, m: jsa.make_sharded_rpe_cross_attention(
        bias_fn, "seq")(q, k, v, ref, kx, m),
        (P(), P(None, "seq"), P(None, "seq"), P(), P(None, "seq"),
         P(None, "seq")), a["q"], a["k"], a["v"], a["ref"], a["kxyz"],
        a["valid"])
    for r in ranks:
        _close(r["rpe_attend"], want)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_sharded_rpe_matches_dense_with_dropout(ranks, rate):
    r = _rpe_arrays()
    names = ("q", "k", "v", "tables")
    t = [torch.from_numpy(r[n]).requires_grad_() for n in names]
    dense = rpe_cross_attention_ad(
        t[0], t[1], t[2], torch.from_numpy(r["corners"]),
        torch.from_numpy(r["angles"]), torch.from_numpy(r["key_xyz"]), t[3],
        torch.from_numpy(r["key_valid"]), log_scale=512.0, max_value=4.0,
        rotate=True, dropout_rate=rate, seed=torch.tensor([r["seed"]]))
    want = torch.autograd.grad((dense * torch.from_numpy(r["w"])).sum(), t)
    nk = r["k"].shape[1]
    for s, rk in enumerate(ranks):
        out, grads, ev = rk["rpe"][rate]
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out, dense.detach(), atol=1e-5, rtol=1e-5)
        assert torch.equal(ev, out)
        sl = slice(s * nk // S, (s + 1) * nk // S)
        np.testing.assert_allclose(grads[1] / S, want[1][:, sl], atol=1e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(grads[2] / S, want[2][:, sl], atol=1e-5,
                                   rtol=1e-4)
    for i in (0, 3):  # q and the tables: each shard's share of the sum
        total = sum(rk["rpe"][rate][1][i] for rk in ranks) / S
        np.testing.assert_allclose(total, want[i], atol=1e-5, rtol=1e-4)
    if rate:
        a = ranks[0]["rpe"][rate][0]
        b = ranks[0]["rpe"][0.0][0]
        assert not torch.allclose(a, b)  # dropout acted


def test_dropout_mask_of_a_shard_is_the_dense_slice():
    seed = torch.tensor([99])
    dense = dropout_keep(seed, 2, 4, 8, 64, 0.1)
    assert torch.equal(dropout_keep(seed, 2, 4, 8, 64, 0.1, key_offset=0),
                       dense)
    for off in (0, 17, 32):
        assert torch.equal(dropout_keep(seed, 2, 4, 8, 16, 0.1, off),
                           dense[..., off:off + 16])
