"""The port's pointnet2 API-parity layer and its last utilities on the
CPU, against the JAX package on the same numpy inputs: the ops
(`ops/ball_query.py`, `ops/gather.py`, `ops/interpolate.py`), the modules
(`models/pointnet2.py`, weights through `convert.load_jax_pointnet2`, in
train mode with batch statistics and in eval mode, and the gradients of
the shared MLP through `convert.pointnet2_jax_trees`), the PLY and OBJ
dumps of `utils/viz.py` byte for byte, and `utils/misc.py`'s
`SmoothedValue`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetr_tpu.models import pointnet2 as jp2
from vdetr_tpu.ops.ball_query import ball_query as j_ball_query
from vdetr_tpu.ops.gather import gather_operation as j_gather
from vdetr_tpu.ops.gather import grouping_operation as j_grouping
from vdetr_tpu.ops.interpolate import interpolate_weights as j_weights
from vdetr_tpu.ops.interpolate import three_interpolate as j_interp
from vdetr_tpu.ops.interpolate import three_nn as j_three_nn
from vdetr_tpu.utils import misc as jmisc
from vdetr_tpu.utils import viz as jviz
from vdetr_tpu_torch.convert import load_jax_pointnet2, pointnet2_jax_trees
from vdetr_tpu_torch.models import pointnet2 as tp2
from vdetr_tpu_torch.ops.ball_query import ball_query
from vdetr_tpu_torch.ops.gather import gather_operation, grouping_operation
from vdetr_tpu_torch.ops.interpolate import (interpolate_weights,
                                             three_interpolate, three_nn)
from vdetr_tpu_torch.utils import misc, viz
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL, RTOL = 1e-5, 1e-5


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want),
                               **({"atol": ATOL, "rtol": RTOL} | kw))


def test_ball_query_matches_jax():
    rng = np.random.RandomState(0)
    xyz = rng.rand(2, 60, 3).astype(np.float32)
    centers = np.concatenate([xyz[:, :5] + 0.01,
                              np.full((2, 1, 3), -50.0, np.float32)], 1)
    valid = np.ones((2, 60), bool)
    valid[1, ::3] = False
    for nsample, mask in ((8, None), (4, valid), (70, valid)):
        want = j_ball_query(0.25, nsample, jnp.asarray(xyz),
                            jnp.asarray(centers),
                            None if mask is None else jnp.asarray(mask))
        got = ball_query(0.25, nsample, torch.from_numpy(xyz),
                         torch.from_numpy(centers),
                         None if mask is None else torch.from_numpy(mask))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the center far away has no hit: all zeros
    assert (got[:, -1] == 0).all()


def test_gather_and_grouping_match_jax():
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 4, 10).astype(np.float32)
    idx = rng.randint(0, 10, (2, 5)).astype(np.int32)
    gidx = rng.randint(0, 10, (2, 3, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        gather_operation(torch.from_numpy(feats), torch.from_numpy(idx)),
        np.asarray(j_gather(jnp.asarray(feats), jnp.asarray(idx))))
    f = torch.from_numpy(feats).requires_grad_()
    out = grouping_operation(f, torch.from_numpy(gidx))
    np.testing.assert_array_equal(
        _np(out), np.asarray(j_grouping(jnp.asarray(feats),
                                        jnp.asarray(gidx))))
    w = rng.randn(*out.shape).astype(np.float32)
    g = torch.autograd.grad((out * torch.from_numpy(w)).sum(), f)[0]
    want = jax.grad(lambda x: (j_grouping(x, jnp.asarray(gidx)) * w).sum())(
        jnp.asarray(feats))
    _close(g, want)


def test_three_nn_and_interpolate_match_jax():
    rng = np.random.RandomState(2)
    known = rng.rand(2, 20, 3).astype(np.float32)
    known[:, 7] = known[:, 3]   # two known points at one place: a tie
    unknown = rng.rand(2, 9, 3).astype(np.float32)
    valid = np.ones((2, 20), bool)
    valid[0, 10:] = False
    feats = rng.randn(2, 5, 20).astype(np.float32)
    for mask in (None, valid):
        jd, ji = j_three_nn(jnp.asarray(unknown), jnp.asarray(known),
                            None if mask is None else jnp.asarray(mask))
        d, i = three_nn(torch.from_numpy(unknown), torch.from_numpy(known),
                        None if mask is None else torch.from_numpy(mask))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        _close(d, jd)
        w, jw = interpolate_weights(d), j_weights(jd)
        _close(w, jw)
        _close(three_interpolate(torch.from_numpy(feats), i, w),
               j_interp(jnp.asarray(feats), ji, jw))


def _jax_module(module, *args, train=False, init_args=None):
    """(variables, (outputs, mutated)) of a flax module on args: the
    variables' shapes from `jax.eval_shape` of its init, the apply one
    compiled program (op by op, each primitive compiled apart)."""
    shapes = jax.eval_shape(lambda k, *a: module.init(k, *a),
                            jax.random.PRNGKey(0), *(init_args or args))
    rng = np.random.RandomState(7)
    # random weights and statistics, not the initial ones
    v = jax.tree.map(lambda x: (
        rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        * np.sign(rng.randn(*x.shape)).astype(np.float32)), shapes)
    v["batch_stats"] = jax.tree.map(np.abs, v["batch_stats"])
    if train:
        out = jax.jit(lambda v, *a: module.apply(
            v, *a, train=True, mutable=["batch_stats"]))(v, *args)
    else:
        out = (jax.jit(module.apply)(v, *args), None)
    return v, out


def _port(module, v, train):
    load_jax_pointnet2(module, v["params"], v["batch_stats"])
    return module.train(train)


@pytest.mark.parametrize("train", [False, True])
def test_sa_module_matches_jax(train):
    rng = np.random.RandomState(3)
    xyz = (rng.rand(2, 128, 3) + 1.0).astype(np.float32)
    feats = rng.randn(2, 128, 6).astype(np.float32)
    jm = jp2.PointnetSAModuleVotes(npoint=16, radius=0.3, nsample=8,
                                   mlp=[16, 16])
    v, (want, mutated) = _jax_module(jm, jnp.asarray(xyz),
                                     jnp.asarray(feats), train=train)
    tm = _port(tp2.PointnetSAModuleVotes(16, 0.3, 8, [16, 16],
                                         in_channels=6), v, train)
    new_xyz, pooled, inds = tm(torch.from_numpy(xyz),
                               torch.from_numpy(feats))
    np.testing.assert_array_equal(inds.numpy(), want[2])  # fps_jax's
    _close(new_xyz, want[0])
    _close(pooled, want[1], atol=1e-4, rtol=1e-4)
    if train:  # the running statistics moved as JAX's
        _, stats = pointnet2_jax_trees(tm, tm.state_dict())
        for a, b in zip(jax.tree.leaves(stats),
                        jax.tree.leaves(mutated["batch_stats"])):
            _close(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_fp_module_matches_jax(train):
    rng = np.random.RandomState(4)
    unknown = rng.rand(2, 32, 3).astype(np.float32)
    known = (unknown[:, :8] + 0.01).astype(np.float32)
    known_feats = rng.randn(2, 8, 4).astype(np.float32)
    unknown_feats = rng.randn(2, 32, 3).astype(np.float32)
    jm = jp2.PointnetFPModule(mlp=[8, 5])
    for with_known in (True, False):
        args = (jnp.asarray(unknown), jnp.asarray(known) if with_known
                else None, jnp.asarray(unknown_feats),
                jnp.asarray(known_feats))
        v, (want, _) = _jax_module(jm, *args, train=train)
        tm = _port(tp2.PointnetFPModule([8, 5], in_channels=7), v, train)
        got = tm(torch.from_numpy(unknown),
                 torch.from_numpy(known) if with_known else None,
                 torch.from_numpy(unknown_feats),
                 torch.from_numpy(known_feats))
        _close(got, want, atol=1e-4, rtol=1e-4)


def test_query_and_group_and_shared_mlp_gradients_match_jax():
    rng = np.random.RandomState(5)
    xyz = rng.rand(1, 64, 3).astype(np.float32)
    feats = rng.randn(1, 64, 2).astype(np.float32)
    g = jp2.QueryAndGroup(radius=0.5, nsample=8)
    want = jax.jit(g.apply)({}, jnp.asarray(xyz), jnp.asarray(xyz[:, :4]),
                            jnp.asarray(feats))
    got = tp2.QueryAndGroup(0.5, 8)(torch.from_numpy(xyz),
                                    torch.from_numpy(xyz[:, :4]),
                                    torch.from_numpy(feats))
    _close(got, want)
    x = rng.randn(2, 6, 5, 5).astype(np.float32)
    jm = jp2.SharedMLP([7, 4])
    v, _ = _jax_module(jm, jnp.asarray(x), train=False)
    w = rng.randn(2, 6, 5, 4).astype(np.float32)

    def jloss(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
        return (out * w).sum()

    want = jax.jit(jax.grad(jloss))(v["params"])
    tm = _port(tp2.SharedMLP(5, [7, 4]), v, True)
    (tm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    got, _ = pointnet2_jax_trees(tm, {n: p.grad for n, p in
                                      tm.named_parameters()})
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(a, b, atol=1e-4, rtol=1e-4)


def test_viz_writes_jax_bytes(tmp_path):
    rng = np.random.RandomState(6)
    pts = rng.randn(20, 3).astype(np.float32)
    colors = rng.randint(0, 256, (20, 3)).astype(np.float32)
    corners = rng.randn(3, 8, 3).astype(np.float32)
    for mod, name in ((jviz, "jax"), (viz, "port")):
        mod.dump_scene(str(tmp_path / name), "scene", pts, corners,
                       corners[:2], colors)
        mod.dump_scene(str(tmp_path / name), "bare", pts, None,
                       corners[:0])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == ["bare_pc.ply", "scene_gt.obj", "scene_pc.ply",
                     "scene_pred.obj"]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n


def test_smoothed_value_matches_jax():
    a, b = jmisc.SmoothedValue(window_size=3), misc.SmoothedValue(3)
    for x in (a, b):
        assert (x.avg, x.global_avg, x.max, x.value) == (0.0, 0.0, 0.0, 0.0)
    for value, n in ((1.0, 1), (4.0, 2), (-2.5, 1), (7.0, 3)):
        a.update(value, n)
        b.update(value, n)
        assert (b.avg, b.global_avg, b.max, b.value, b.count) == \
            (a.avg, a.global_avg, a.max, a.value, a.count)
