"""The port's training-side pieces against the JAX package, on the CPU,
each from a numpy seed: train-mode norms, the keyed conv's gradients,
the RPE attention's gradients and its dropout, GIoU and points-in-boxes,
the exact JV matcher, and the learning-rate schedule. The Hopper kernels
themselves are held to these plain versions by tests/test_torch_cuda.py
and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import jax_vjp
from vdetr_tpu.config import VDETRConfig as JaxConfig
from vdetr_tpu.geometry.boxes import \
    box_parametrization_to_corners as jax_corners
from vdetr_tpu.geometry.iou import generalized_box3d_iou as jax_giou
from vdetr_tpu.geometry.points_in_boxes import \
    points_in_boxes_all as jax_pib
from vdetr_tpu.models import norm as jnorm
from vdetr_tpu.ops.hungarian import hungarian as jax_hungarian
from vdetr_tpu.ops.rpe_attention import rpe_cross_attention_reference
from vdetr_tpu.ops.sparse_conv import _gather_matmul, _zrun_neighbors
from vdetr_tpu.train.schedule import make_lr_schedule as jax_schedule
from vdetr_tpu_torch.config import VDETRConfig
from vdetr_tpu_torch.geometry.iou import generalized_box3d_iou
from vdetr_tpu_torch.geometry.points_in_boxes import points_in_boxes_all
from vdetr_tpu_torch.models.norm import BatchNorm1d, MaskedBatchNorm
from vdetr_tpu_torch.ops.hungarian import hungarian
from vdetr_tpu_torch.ops.rpe_attention import (dropout_keep,
                                               rpe_cross_attention_ad,
                                               rpe_cross_attention_plain)
from vdetr_tpu_torch.ops.sparse_conv_keyed import keyed_conv_ad
from vdetr_tpu_torch.ops.voxelize import downsample_grid, voxelize
from vdetr_tpu_torch.train.schedule import make_lr_schedule
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.from_numpy


# --------------------------------------------------------------------------
# norms in train mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [True, False])
def test_train_mode_norms_match_jax(rng, masked):
    """Outputs from the batch statistics (valid rows only when masked)
    and the running statistics after one momentum step. f32 moments of
    ~100 rows: 1e-5."""
    C = 6
    x = (rng.randn(2, 50, C) * 3 + 1).astype(np.float32)
    mask = rng.rand(2, 50) > 0.3
    mean0 = (0.1 * rng.randn(C)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, C).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    if masked:
        ref, upd = jnorm.MaskedBatchNorm(C).apply(
            variables, x, mask, mutable=["batch_stats"])
        mod = MaskedBatchNorm(C)
        bn = mod.bn
    else:
        ref, upd = jnorm.BatchNorm1d(C).apply(
            variables, x, mutable=["batch_stats"])
        mod = bn = BatchNorm1d(C)
    with torch.no_grad():
        bn.weight.copy_(T(scale))
        bn.bias.copy_(T(bias))
        bn.running_mean.copy_(T(mean0))
        bn.running_var.copy_(T(var0))
    mod.train()
    got = mod(T(x), T(mask)) if masked else mod(T(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    mod.eval()  # eval mode reads the updated running statistics
    updated = {"params": variables["params"],
               "batch_stats": upd["batch_stats"]}
    ref_eval = (jnorm.MaskedBatchNorm(C, use_running_average=True).apply(
        updated, x, mask) if masked else
        jnorm.BatchNorm1d(C, use_running_average=True).apply(updated, x))
    got_eval = mod(T(x), T(mask)) if masked else mod(T(x))
    np.testing.assert_allclose(got_eval.detach().numpy(),
                               np.asarray(ref_eval), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# keyed conv gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2], ids=["submanifold", "stride-2"])
@pytest.mark.parametrize("cin,cout", [(3, 8), (12, 20)])
def test_keyed_conv_gradients_match_jax_vjp(rng, stride, cin, cout):
    """dFeats and dW of the port's conv (the flipped-weight conv for a
    submanifold conv, the transpose scatter for a strided one) against
    jax.vjp of _gather_matmul over _zrun_neighbors. f32 sums of up to
    27 * C terms per entry: 1e-5 of the largest."""
    pts = (rng.rand(2, 700, 3) * [0.5, 0.4, 0.3]).astype(np.float32)
    g = voxelize(T(pts), T(pts), torch.ones(2, 700, dtype=torch.bool),
                 voxel_size=0.02, capacity=1024, extent=(64, 64, 32))
    go = downsample_grid(g, 512) if stride == 2 else g
    q = (go.coords * 2 if stride == 2 else go.coords).contiguous()
    feats = (rng.randn(2, 1024, cin) * g.valid.numpy()[..., None]
             ).astype(np.float32)
    w = (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    dout = (rng.randn(2, go.capacity, cout) * go.valid.numpy()[..., None]
            ).astype(np.float32)

    nbr = jax.jit(jax.vmap(
        lambda k, c, v: _zrun_neighbors(k, c, v, g.extent, 1)))(
        jnp.asarray(g.keys.numpy()), jnp.asarray(q.numpy()),
        jnp.asarray(go.valid.numpy()))
    out_j, (df_j, dw_j) = jax_vjp(
        lambda f, ww: jax.vmap(lambda ff, ii: _gather_matmul(ff, ii, ww))(
            f, nbr), (feats, w), dout)

    f_t, w_t = T(feats).requires_grad_(), T(w).requires_grad_()
    out = keyed_conv_ad(f_t, g.keys, q, go.valid, g.extent, w_t,
                        submanifold=stride == 1)
    df, dw = torch.autograd.grad(out, (f_t, w_t), T(dout))
    for got, ref in ((out.detach(), out_j), (df, df_j), (dw, dw_j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("kind", ["skip-grid", "generative"])
def test_transpose_conv_gradients_match_jax_vjp(rng, kind):
    """dFeats (the coarse features) and dW of the kernel-2 transpose conv,
    whose parent gather differentiates by adding each coarse row's up to
    8 children in slot order (`_ParentGather`), against jax.vjp of the
    JAX package's `sparse_conv_transpose` (at the skip grid's sites, or
    at all 8 children of every coarse site); and the same bits from a
    second backward. f32 sums of <= 8 rows per entry, then 8 masked
    matmuls: 1e-5 of the largest."""
    import importlib

    from vdetr_tpu.ops import sparse_conv as jsc
    from vdetr_tpu_torch.ops import sparse_conv as tsc

    jvox = importlib.import_module("vdetr_tpu.ops.voxelize")
    pts = (rng.rand(2, 900, 3) * [0.5, 0.4, 0.3]).astype(np.float32)
    valid = rng.rand(2, 900) > 0.05
    jg, jc = jax.jit(lambda p, v: (lambda g: (g, jvox.downsample_grid(
        g, 512)))(jvox.voxelize(p, p, v, voxel_size=0.02, capacity=1024,
                                extent=(64, 64, 32))))(pts, valid)
    tg = voxelize(T(pts), T(pts), T(valid), voxel_size=0.02, capacity=1024,
                  extent=(64, 64, 32))
    tc = downsample_grid(tg, 512)
    cin, cout = 6, 5
    feats = (rng.randn(2, 512, cin) * tc.valid.numpy()[..., None]
             ).astype(np.float32)
    w = (rng.randn(8, cin, cout) / np.sqrt(8 * cin)).astype(np.float32)
    fine_cap = 1024 if kind == "skip-grid" else 2048
    dout = rng.randn(2, fine_cap, cout).astype(np.float32)

    def jax_fn(f, ww):
        c = jc.replace(features=f)
        out = (jsc.sparse_conv_transpose(c, jg, ww) if kind == "skip-grid"
               else jsc.sparse_conv_transpose_generative(c, ww, fine_cap))
        return out.features

    out_j, (df_j, dw_j) = jax_vjp(jax_fn, (feats, w), dout)
    grads = []
    for _ in range(2):
        f_t, w_t = T(feats).requires_grad_(), T(w).requires_grad_()
        c = tc.replace(features=f_t)
        out = (tsc.sparse_conv_transpose(c, tg, w_t) if kind == "skip-grid"
               else tsc.sparse_conv_transpose_generative(c, w_t, fine_cap))
        grads.append(torch.autograd.grad(out.features, (f_t, w_t),
                                         T(dout)))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert float(grads[0][0].abs().max()) > 0
    for got, ref in ((out.features.detach(), out_j), (grads[0][0], df_j),
                     (grads[0][1], dw_j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_parent_gather_backward_sums_children_in_slot_order(rng):
    """`_ParentGather`'s backward equals autograd's gather backward (a
    scatter-add) exactly where each coarse row has at most one child with
    a nonzero gradient, and every coarse row with children gets their
    sum: the child lookup finds exactly the fine rows whose parent lookup
    found the row."""
    from vdetr_tpu_torch.ops import sparse_conv as tsc
    from vdetr_tpu_torch.ops.voxelize import (KEY_SENTINEL, gather_rows,
                                              lookup, pack_keys)

    pts = (rng.rand(1, 900, 3) * [0.5, 0.4, 0.3]).astype(np.float32)
    fine = voxelize(T(pts), T(pts), torch.ones(1, 900, dtype=torch.bool),
                    voxel_size=0.02, capacity=1024, extent=(64, 64, 32))
    coarse = downsample_grid(fine, 512)
    feats = torch.randn(1, 512, 3, requires_grad=True)
    pk = torch.where(fine.valid, pack_keys(fine.coords // 2, coarse.extent),
                     KEY_SENTINEL)
    parent = lookup(coarse.keys, pk)
    dx = torch.randn(1, 1024, 3)
    ref, = torch.autograd.grad(gather_rows(feats, parent), feats, dx)
    got, = torch.autograd.grad(
        tsc._ParentGather.apply(feats, parent, coarse, fine), feats, dx)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    children = tsc.child_rows(coarse, fine)
    hit = children < 1024
    assert int(hit.sum()) == int((parent < 512).sum())
    # each child's parent lookup finds the coarse row that lists it
    rows = torch.arange(512).expand(8, -1)[None]
    assert torch.equal(parent[0, children[hit]], rows[hit])


# --------------------------------------------------------------------------
# RPE attention gradients and dropout
# --------------------------------------------------------------------------

KW = dict(log_scale=512.0, max_value=4.0)


def rpe_case(rng, B=2, nQ=12, nK=40, H=4, hd=8, n=10):
    """Decoder-like inputs with corner pairs sharing x/y, a partial key
    mask and one batch row whose keys are all masked."""
    q = rng.randn(B, nQ, H, hd).astype(np.float32) * 0.3
    k = rng.randn(B, nK, hd).astype(np.float32) * 0.3
    v = rng.randn(B, nK, hd).astype(np.float32)
    centers = rng.rand(B, nQ, 3).astype(np.float32) * 4
    sizes = rng.rand(B, nQ, 3).astype(np.float32) + 0.3
    offs = np.array([[i, j, l] for l in (-1, 1) for i in (-1, 1)
                     for j in (-1, 1)], np.float32) / 2
    corners = (centers[:, :, None] + offs[None, None] * sizes[:, :, None]
               ).astype(np.float32)
    angles = (rng.rand(B, nQ).astype(np.float32) - 0.5) * 2
    key_xyz = rng.rand(B, nK, 3).astype(np.float32) * 4
    tables = rng.randn(8, n, n, n, H).astype(np.float32) * 0.3
    key_valid = rng.rand(B, nK) > 0.2
    key_valid[-1] = False
    return q, k, v, corners, angles, key_xyz, tables, key_valid


@pytest.mark.parametrize("rotate", [False, True])
def test_rpe_gradients_match_jax_vjp(rng, rotate):
    """dQ, dK, dV and dTables of the Function (training forward, flash
    backward, dK/dV matmuls) at dropout 0 against jax.vjp of
    rpe_cross_attention_reference, a fully masked batch row included.
    f32 sums over 40 keys and ~4k taps: 1e-5 of the largest."""
    q, k, v, corners, angles, key_xyz, tables, key_valid = rpe_case(rng)
    dout = rng.randn(*q.shape).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda q_, k_, v_, t_: rpe_cross_attention_reference(
            q_, k_, v_, jnp.asarray(corners), jnp.asarray(angles),
            jnp.asarray(key_xyz), t_, jnp.asarray(key_valid), **KW,
            rotate=rotate), *map(jnp.asarray, (q, k, v, tables)))
    grads_j = vjp(jnp.asarray(dout))
    leaves = [T(a).requires_grad_() for a in (q, k, v, tables)]
    out = rpe_cross_attention_ad(leaves[0], leaves[1], leaves[2], T(corners),
                                 T(angles), T(key_xyz), leaves[3],
                                 T(key_valid), **KW, rotate=rotate)
    grads = torch.autograd.grad(out, leaves, T(dout))
    for name, got, ref in zip(("out", "dq", "dk", "dv", "dtables"),
                              (out.detach(),) + grads, (out_j,) + grads_j):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   err_msg=name)


def test_rpe_dropout_mask_is_replayed_and_keeps_its_share():
    """One seed gives one mask, another seed another; the kept share is
    1 - rate within 4 standard deviations of a Bernoulli count."""
    seed = torch.tensor([42], dtype=torch.int64)
    a = dropout_keep(seed, 2, 4, 64, 256, 0.3)
    assert torch.equal(a, dropout_keep(seed, 2, 4, 64, 256, 0.3))
    b = dropout_keep(seed + 1, 2, 4, 64, 256, 0.3)
    assert 0.55 < float((a == b).float().mean()) < 0.62  # ~0.7^2 + 0.3^2
    n = a.numel()
    assert abs(float(a.float().mean()) - 0.7) < 4 * np.sqrt(0.21 / n)
    assert not bool(dropout_keep(seed, 2, 4, 64, 256, 0.0).logical_not().any())


@pytest.mark.parametrize("rotate", [False, True])
def test_rpe_dropout_backward_is_autograd_of_the_plain_forward(rng, rotate):
    """With dropout on, the Function's flash backward equals autograd of
    the plain forward under the same hash mask, and the forward drops
    exactly that mask: the output equals the masked softmax average."""
    case = rpe_case(rng)
    dout = T(rng.randn(*case[0].shape).astype(np.float32))
    seed = torch.tensor([9], dtype=torch.int64)
    kw = dict(KW, rotate=rotate, dropout_rate=0.25, seed=seed)
    grads = []
    for fn in (rpe_cross_attention_ad, rpe_cross_attention_plain):
        leaves = [T(a).requires_grad_() for a in (case[0], case[1], case[2],
                                                  case[6])]
        out = fn(leaves[0], leaves[1], leaves[2], T(case[3]), T(case[4]),
                 T(case[5]), leaves[3], T(case[7]), **kw)
        grads.append((out.detach(),) + torch.autograd.grad(out, leaves, dout))
    for got, ref in zip(*grads):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, ref.abs().max()))
    # the mask itself: p * keep / (1 - rate) of the undropped softmax
    args = [T(a) for a in case]
    p0 = rpe_cross_attention_plain(*args, **KW, rotate=rotate,
                                   return_stats=True)[2].softmax(-1)
    keep = dropout_keep(seed, *p0.shape, 0.25)
    want = torch.einsum("bhqk,bkd->bqhd", p0 * keep / 0.75, args[2])
    np.testing.assert_allclose(grads[0][0].numpy(), want.numpy(), rtol=0,
                               atol=1e-5)


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------

def test_giou_matches_jax(rng):
    """Axis-aligned boxes, overlapping and apart, with GT columns past
    each count masked. Exact formulas in f32: 1e-6."""
    B, K1, K2 = 2, 30, 9

    def corners(n):
        c = (rng.rand(B, n, 3) * 1.5).astype(np.float32)
        s = (rng.rand(B, n, 3) * 1.5 + 0.05).astype(np.float32)
        return np.asarray(jax.jit(jax_corners)(
            c, s, np.zeros((B, n), np.float32)))

    c1, c2 = corners(K1), corners(K2)
    nums = np.array([9, 4])
    ref = jax.jit(jax_giou)(jnp.asarray(c1), jnp.asarray(c2),
                            jnp.asarray(nums))
    got = generalized_box3d_iou(T(c1), T(c2), T(nums))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    assert (np.asarray(ref)[1, :, 4:] == 0).all()
    assert (np.asarray(ref) > 0).any() and (np.asarray(ref) < 0).any()


def test_points_in_boxes_match_jax(rng):
    points = (rng.rand(2, 300, 3) * 3).astype(np.float32)
    boxes = np.concatenate([rng.rand(2, 7, 3) * 3, rng.rand(2, 7, 3) + 0.5,
                            (rng.rand(2, 7, 1) - 0.5) * 3],
                           axis=-1).astype(np.float32)
    ref = np.asarray(jax_pib(jnp.asarray(points), jnp.asarray(boxes)))
    got = points_in_boxes_all(T(points), T(boxes)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.sum() < ref.size


# --------------------------------------------------------------------------
# matcher and schedule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["continuous", "ties", "repeated-rows"])
def test_jv_assignments_equal_jax(rng, kind):
    """The host solver's col4row equals the JAX solver's on the same
    costs: continuous costs, integer costs full of ties, and costs with
    repeated rows (ground truth repeated for the matcher)."""
    B, n, m = 3, 20, 45
    if kind == "continuous":
        cost = rng.randn(B, n, m).astype(np.float32)
    elif kind == "ties":
        cost = rng.randint(0, 4, (B, n, m)).astype(np.float32)
    else:
        base = rng.randn(B, n // 4, m).astype(np.float32)
        cost = np.concatenate([base] * 4, axis=1)
    n_valid = np.array([n, 13, 0])
    ref = np.asarray(jax_hungarian(jnp.asarray(cost), jnp.asarray(n_valid)))
    got = hungarian(cost, n_valid)
    np.testing.assert_array_equal(got, ref)
    assert (got[1, 13:] == -1).all() and (got[2] == -1).all()


@pytest.mark.parametrize("sched", ["cosine", "step"])
def test_lr_schedule_matches_jax(sched):
    """tests/test_train_step.py's points on the published recipe, and
    the JAX schedule itself over the whole run, warmup and decay."""
    kw = dict(max_epoch=540, warm_lr_epochs=9, base_lr=7e-4, warm_lr=1e-6,
              final_lr=1e-6)
    if sched == "step":
        kw.update(lr_scheduler="step", step_epoch="300_450")
    f = make_lr_schedule(VDETRConfig(**kw), steps_per_epoch=100)
    ref = jax_schedule(JaxConfig(**kw), steps_per_epoch=100)
    if sched == "cosine":
        assert f(0) == pytest.approx(1e-6, rel=1e-3)
        assert f(9 * 100) == pytest.approx(7e-4, rel=1e-2)
        assert f(270 * 100) == pytest.approx((7e-4 + 1e-6) / 2, rel=1e-2)
        assert f(540 * 100) == pytest.approx(1e-6, rel=1e-2)
    for step in list(range(0, 54001, 997)) + [899, 900, 901, 54000, 60000]:
        assert f(step) == pytest.approx(float(ref(step)), rel=1e-5), step
