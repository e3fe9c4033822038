"""The port's rotated box overlaps against `vdetr_tpu.geometry.iou`.

- The rotated GIoU (`generalized_box3d_iou(..., rotated_boxes=True)`):
  kernel R's plain version, `ops/rotated_iou.py:clip_quad_quad_plain`,
  on random rotated boxes and on the edge cases (identical boxes, a box
  inside another, shared and collinear edges, touching corners,
  zero-size boxes, pairs the corner-1/3 gate turns off although they
  overlap, pairs that clip to fewer than three vertices), with the GT
  columns past `nums_k2` masked, and `return_inter_vols_only`: values,
  and the gradient of sum(w * (1 - giou)) over a random pair mask.
- `diff_iou_rotated_3d` and `diff_diou_rotated_3d`: values and gradients.

JAX's gradients of these functions are NaN wherever an unused
intersection has a zero denominator (a zero cotangent times 1 / (den +
1e-30)^2 = inf): a subject edge parallel to a clip edge, and every pair
with a padded zero-size GT box, so every row of a criterion job. The port
computes the same forward and gives those intersections a denominator
of 1. `jax_guarded()` patches the same guard into the JAX functions for
the duration of a comparison (the JAX package's files are not changed);
`test_jax_gradient_is_nan_where_unguarded` shows the difference and that
the guard leaves JAX's values as they are. The JAX side runs under
`jax.jit` (op by op it compiles each loop's body anew, ~5x slower).

Two rotated boxes whose edges coincide are not compared with JAX: their
vertices lie on the clip lines, where the strict inside test goes either
way with the rounding (XLA on the CPU fuses multiply-adds, the port
rounds each operation), and the clip differs by whole vertices. Kernel R
is held to the plain version on such pairs bit for bit (`chip_smoke.py`).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vdetr_tpu.geometry.iou as jiou
from vdetr_tpu.geometry.boxes import \
    box_parametrization_to_corners as jax_corners
from vdetr_tpu_torch.data.dataset_config import SunrgbdDatasetConfig
from vdetr_tpu_torch.geometry import iou as tiou
from vdetr_tpu_torch.geometry.boxes import \
    box_parametrization_to_corners as port_corners
from vdetr_tpu_torch.ops.rotated_iou import (clip_quad_quad_plain,
                                             rotated_intersection_areas)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# f32 clips and sums in other orders (XLA on the CPU may fuse
# multiply-adds): a few ulps of areas ~1 m^2
VALUE_ATOL = 2e-5
# gradients through ~100 f32 operations a pair, relative to the largest
GRAD_RTOL = 1e-4


# --------------------------------------------------------------------------
# the JAX functions with the port's guard, for the duration of a comparison
# --------------------------------------------------------------------------

def _clip_quad_quad_guarded(subject, clip):
    """`vdetr_tpu/geometry/iou.py:_clip_quad_quad`, an intersection that is
    not appended dividing by 1."""
    dt = subject.dtype
    poly = jnp.zeros((jiou._MAXV, 2), dt).at[:4].set(subject)
    n = jnp.asarray(4, jnp.int32)

    def clip_edge(carry, edge_idx):
        poly, n = carry
        cp1 = clip[(edge_idx + 3) % 4]
        cp2 = clip[edge_idx]
        d = cp2 - cp1

        def inside(p):
            return d[0] * (p[..., 1] - cp1[1]) > d[1] * (p[..., 0] - cp1[0])

        def intersect(s, e, used):
            dp = s - e
            n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
            n2 = s[0] * e[1] - s[1] * e[0]
            dc = -d
            den = dc[0] * dp[1] - dc[1] * dp[0] + 1e-30
            n3 = 1.0 / jnp.where(used, den, 1.0)
            return jnp.stack(
                [(n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3]
            )

        out = jnp.zeros((jiou._MAXV, 2), dt)
        m = jnp.asarray(0, jnp.int32)
        s0 = poly[jnp.maximum(n - 1, 0)]

        def body(i, carry):
            out, m, s = carry
            valid = i < n
            e = poly[i]
            ins_e = inside(e)
            ins_s = inside(s)
            add_x = valid & (ins_e != ins_s)
            x = intersect(s, e, add_x)
            out = out.at[m].set(jnp.where(add_x, x, out[m]))
            m = m + add_x.astype(jnp.int32)
            add_e = valid & ins_e
            out = out.at[m].set(jnp.where(add_e, e, out[m]))
            m = m + add_e.astype(jnp.int32)
            s = jnp.where(valid, e, s)
            return out, m, s

        out, m, _ = jax.lax.fori_loop(0, jiou._MAXV, body, (out, m, s0))
        return (out, m), None

    (poly, n), _ = jax.lax.scan(clip_edge, (poly, n), jnp.arange(4))
    idx = jnp.arange(jiou._MAXV)
    nxt = jnp.where(idx + 1 < n, idx + 1, 0)
    x, y = poly[:, 0], poly[:, 1]
    contrib = x * y[nxt] - y * x[nxt]
    contrib = jnp.where(idx < n, contrib, 0.0)
    area = 0.5 * jnp.abs(contrib.sum())
    return jnp.where(n >= 3, area, jnp.zeros((), dt))


def _pair_intersection_area_guarded(c1, c2):
    """`vdetr_tpu/geometry/iou.py:_pair_intersection_area`, a parallel
    edge pair dividing by 1."""
    def inside_quad(p, quad):
        a = quad
        b = jnp.roll(quad, -1, axis=0)
        cross = (b[:, 0] - a[:, 0]) * (p[1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (
            p[0] - a[:, 0]
        )
        return (cross >= -1e-9).all() | (cross <= 1e-9).all()

    in12 = jax.vmap(lambda p: inside_quad(p, c2))(c1)
    in21 = jax.vmap(lambda p: inside_quad(p, c1))(c2)
    a1, b1 = c1, jnp.roll(c1, -1, axis=0)
    a2, b2 = c2, jnp.roll(c2, -1, axis=0)

    def seg_isect(p1, p2, p3, p4):
        d1 = p2 - p1
        d2 = p4 - p3
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        skew = jnp.abs(denom) > 1e-12
        den = jnp.where(skew, denom + 1e-30, 1.0)
        t = ((p3[0] - p1[0]) * d2[1] - (p3[1] - p1[1]) * d2[0]) / den
        u = ((p3[0] - p1[0]) * d1[1] - (p3[1] - p1[1]) * d1[0]) / den
        ok = skew & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
        return p1 + t * d1, ok

    def edge_pairs(i, j):
        return seg_isect(a1[i], b1[i], a2[j], b2[j])

    ii, jj = jnp.meshgrid(jnp.arange(4), jnp.arange(4), indexing="ij")
    ipts, iok = jax.vmap(jax.vmap(edge_pairs))(ii, jj)
    pts = jnp.concatenate([c1, c2, ipts.reshape(16, 2)], axis=0)
    mask = jnp.concatenate([in12, in21, iok.reshape(16)], axis=0)
    return jiou._convex_area_from_candidates(pts, mask)


@contextlib.contextmanager
def jax_guarded():
    """The JAX package's rotated overlaps with the port's guard against
    NaN gradients, for the duration of the block."""
    saved = jiou._clip_quad_quad, jiou._pair_intersection_area
    jiou._clip_quad_quad = _clip_quad_quad_guarded
    jiou._pair_intersection_area = _pair_intersection_area_guarded
    try:
        yield
    finally:
        jiou._clip_quad_quad, jiou._pair_intersection_area = saved


# --------------------------------------------------------------------------
# cases
# --------------------------------------------------------------------------

_DS = SunrgbdDatasetConfig()


def corners(boxes):
    """(..., 7) center, size, yaw -> (..., 8, 3) camera-frame corners."""
    boxes = np.asarray(boxes, np.float32)
    return _DS.box_parametrization_to_corners_np(
        boxes[..., :3], boxes[..., 3:6], boxes[..., 6])


def random_boxes(rng, *shape):
    return np.concatenate([rng.randn(*shape, 3) * 0.6,
                           rng.rand(*shape, 3) * 1.5 + 0.2,
                           rng.rand(*shape, 1) * 2 * np.pi - np.pi],
                          -1).astype(np.float32)


def edge_case_boxes():
    """(preds (1, 10, 7), gt (1, 6, 7)): axis-aligned ones on exact binary
    fractions, so that every product is exact in f32 whatever the order."""
    unit = [0, 0, 0, 1, 1, 1, 0]
    gt = [unit,
          [3, 0, 0, 2, 2, 1, 0.3],            # rotated
          [0, 3, 0, 0, 0, 0, 0],              # zero size
          [6, 6, 0, 1, 1, 1, 0],
          [-3, -3, 0, 1, 2, 1, 0],
          [-6, 0, 0, 1, 1, 1, 0]]
    preds = [unit,                            # identical to gt 0
             [0, 0, 0, 0.5, 0.5, 0.5, 0],     # inside gt 0
             [1, 0, 0, 1, 1, 1, 0],           # shares an edge with gt 0
             [0.5, 0.25, 0, 1, 0.5, 1, 0],    # collinear edges, overlap
             [1, 1, 0, 1, 1, 1, 0],           # touches gt 0 at a corner
             [0, 0, 0, 0, 0, 0, 0],           # zero size
             [0, 0, 0, 1, 1, 1, np.pi],       # gate off (corners 1/3
                                              # swapped) over gt 0
             [3.125, 0, 0, 2, 2, 1, 0.3],     # gt 1 shifted: parallel
                                              # edges
             [3.9, 0.9, 0, 0.25, 0.25, 1, 1.0],  # a sliver or nothing
             [-3, -3, 0.25, 1, 2, 1, 0.7]]    # rotated over gt 4
    return (np.asarray([preds], np.float32), np.asarray([gt], np.float32))


def _giou_both(c1, c2, nk, **kw):
    got = tiou.generalized_box3d_iou(
        torch.from_numpy(c1), torch.from_numpy(c2),
        torch.from_numpy(nk).long(), rotated_boxes=True, **kw)
    want = jax.jit(lambda a, b, n: jiou.generalized_box3d_iou(
        a, b, n, rotated_boxes=True, **kw))(jnp.asarray(c1), jnp.asarray(c2),
                                            jnp.asarray(nk))
    return got.numpy(), np.asarray(want)


def giou_cases():
    rng = np.random.RandomState(0)
    p, g = random_boxes(rng, 2, 14), random_boxes(rng, 2, 9)
    yield "random", corners(p), corners(g), np.array([9, 5], np.int32)
    p, g = edge_case_boxes()
    yield "edge cases", corners(p), corners(g), np.array([6], np.int32)


@pytest.mark.parametrize("only_inter", [False, True])
def test_rotated_giou_values_match_jax(only_inter):
    for name, c1, c2, nk in giou_cases():
        got, want = _giou_both(c1, c2, nk, return_inter_vols_only=only_inter)
        np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_ATOL,
                                   err_msg=name)


def test_rotated_edge_cases_are_exercised():
    """The edge cases hit what they are named for: the gate turns off an
    overlapping pair, some pairs clip to fewer than three vertices, and
    the exact areas of the axis-aligned ones."""
    p, g = edge_case_boxes()
    r1 = tiou._bev_rects(torch.from_numpy(corners(p)))
    r2 = tiou._bev_rects(torch.from_numpy(corners(g)))
    ungated = rotated_intersection_areas(r1, r2, torch.ones(1, 10, 6,
                                                            dtype=bool))[0]
    inter = tiou.generalized_box3d_iou(
        torch.from_numpy(corners(p)), torch.from_numpy(corners(g)),
        rotated_boxes=True, return_inter_vols_only=True)[0]
    assert float(ungated[6, 0]) > 0.9 and float(inter[6, 0]) == 0.0
    assert float(inter[1, 0]) == 0.125       # inside: 0.5^3
    assert float(inter[3, 0]) == 0.25        # collinear: 0.5 x 0.5 x 1
    assert float(inter[2, 0]) == 0.0         # shared edge
    assert float(inter[4, 0]) == 0.0         # touching corner
    assert float(inter[5].abs().sum()) == 0.0  # zero size
    assert float(inter[0, 0]) == pytest.approx(1.0)  # identical
    # pairs whose clip leaves fewer than three vertices give 0
    sub = r1[0, :, None].expand(-1, 6, -1, -1)
    clip = r2[0, None].expand(10, -1, -1, -1)
    assert (clip_quad_quad_plain(sub, clip) == 0).sum() > 30


def _giou_loss_grads(p, c2, nk, w):
    """d/d (center, size, yaw) of the predictions p (B, K1, 7) of
    sum(w * (1 - giou)), through each package's corner construction: the
    corners' own gradients differ where a corner ties another for an
    extent (torch's min/max over a dim takes one, JAX splits it)."""
    tp = torch.from_numpy(p).requires_grad_()
    c1 = port_corners(tp[..., :3], tp[..., 3:6], tp[..., 6])
    giou = tiou.generalized_box3d_iou(c1, torch.from_numpy(c2),
                                      torch.from_numpy(nk).long(),
                                      rotated_boxes=True)
    (torch.from_numpy(w) * (1 - giou)).sum().backward()

    def f(x):
        g = jiou.generalized_box3d_iou(
            jax_corners(x[..., :3], x[..., 3:6], x[..., 6]), jnp.asarray(c2),
            jnp.asarray(nk), rotated_boxes=True)
        return (jnp.asarray(w) * (1 - g)).sum()

    with jax_guarded():
        want = np.array(jax.jit(jax.grad(f))(jnp.asarray(p)))
    return tp.grad.numpy(), want


@pytest.mark.parametrize("case", ["random", "edge cases"])
def test_rotated_giou_gradient_matches_jax(case):
    rng = np.random.RandomState(1)
    if case == "random":
        p, g = random_boxes(rng, 2, 14), random_boxes(rng, 2, 9)
        nk = np.array([9, 5], np.int32)
    else:
        (p, g), nk = edge_case_boxes(), np.array([6], np.int32)
    shape = (p.shape[0], p.shape[1], g.shape[1])
    w = (rng.rand(*shape) * (rng.rand(*shape) < 0.3)).astype(np.float32)
    got, want = _giou_loss_grads(p, corners(g), nk, w)
    if case == "edge cases":
        # the zero-size prediction's GIoU divides by an enclosing volume
        # of 0: its gradient is NaN in both packages (and in the
        # axis-aligned GIoU); the model's sizes are exp(.) > 0
        assert np.isnan(want[0, 5]).all() and np.isnan(got[0, 5]).all()
        # at yaw 0 tied corners span each extent of the enclosing box and
        # move apart when it turns: a kink, where torch's max over a dim
        # (the unchanged axis-aligned code) and JAX's tie split take other
        # subgradients; the other components are compared
        yaw0 = p[0, :, 6] == 0
        want[0, yaw0, 6] = got[0, yaw0, 6] = 0
        want, got = np.delete(want, 5, 1), np.delete(got, 5, 1)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_RTOL * np.abs(want).max())


def test_jax_gradient_is_nan_where_unguarded():
    """JAX's own gradient of the rotated GIoU is NaN on a batch row with a
    padded (zero-size) GT column, masked or not, and its diff IoU's on a
    pair with one; the guard changes no value."""
    rng = np.random.RandomState(2)
    p, g = random_boxes(rng, 1, 5), random_boxes(rng, 1, 4)
    g[:, 2:] = 0  # two padded GT slots
    c1, c2 = corners(p), corners(g)
    nk = np.array([2], np.int32)

    def f(x):
        return jiou.generalized_box3d_iou(x, jnp.asarray(c2), jnp.asarray(nk),
                                          rotated_boxes=True).sum()

    raw_v, raw_g = jax.jit(jax.value_and_grad(f))(jnp.asarray(c1))
    with jax_guarded():
        safe_v, safe_g = jax.jit(jax.value_and_grad(f))(jnp.asarray(c1))
    assert float(raw_v) == float(safe_v)
    assert np.isnan(np.asarray(raw_g)).any()
    assert np.isfinite(np.asarray(safe_g)).all()

    a, b = jnp.asarray(p[0, :4]), jnp.asarray(g[0])

    def h(x):
        return jiou.diff_diou_rotated_3d(x, b).sum()

    raw_v, raw_g = jax.jit(jax.value_and_grad(h))(a)
    with jax_guarded():
        safe_v, safe_g = jax.jit(jax.value_and_grad(h))(a)
    assert float(raw_v) == float(safe_v)
    assert np.isnan(np.asarray(raw_g)[2:]).any(axis=1).all()
    assert np.isfinite(np.asarray(safe_g)).all()
    np.testing.assert_array_equal(np.asarray(raw_g)[:2],
                                  np.asarray(safe_g)[:2])


@pytest.mark.parametrize("fn", ["diff_iou_rotated_3d",
                                "diff_diou_rotated_3d"])
def test_diff_iou_family_matches_jax(fn):
    """Values on random pairs, pairs near each other, identical pairs and
    padded GT; the gradient of sum(w * value) in the first box (the
    prediction: the criterion differentiates nothing else) on all but the
    identical pairs, where the function has no derivative (coincident
    candidates, and which of them the hull takes is the sort's tie
    order)."""
    rng = np.random.RandomState(3)
    a = random_boxes(rng, 3, 40)
    b = random_boxes(rng, 3, 40)
    b[:, 10:20] = a[:, 10:20] + rng.randn(3, 10, 7).astype(np.float32) * 0.1
    b[:, 20:25] = a[:, 20:25]
    b[:, 35:] = 0
    w = rng.rand(3, 40).astype(np.float32)
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    val = getattr(tiou, fn)(ta, tb)
    (torch.from_numpy(w) * val).sum().backward()
    jfn = getattr(jiou, fn)
    with jax_guarded():
        want = np.asarray(jax.jit(jfn)(jnp.asarray(a), jnp.asarray(b)))
        ga = jax.jit(jax.grad(lambda x: (jnp.asarray(w) * jfn(
            x, jnp.asarray(b))).sum()))(jnp.asarray(a))
    np.testing.assert_allclose(val.detach().numpy(), want, rtol=0,
                               atol=VALUE_ATOL)
    keep = np.ones(40, bool)
    keep[20:25] = False
    got, g = ta.grad.numpy()[:, keep], np.asarray(ga)[:, keep]
    assert np.isfinite(g).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, g, rtol=0,
                               atol=GRAD_RTOL * np.abs(g).max())
    assert torch.isfinite(ta.grad).all() and torch.isfinite(tb.grad).all()


def test_clip_plain_equals_the_jax_loop():
    """`clip_quad_quad_plain` (kernel R's plain version) against JAX's
    `_clip_quad_quad` on
    every pair of 30 quads, vmapped, with quads that clip to 8 vertices
    (two squares at 45 degrees)."""
    rng = np.random.RandomState(4)
    p = random_boxes(rng, 1, 30)
    p[0, :4] = [[0, 0, 0, 1, 1, 1, 0], [0, 0, 0, 1, 1, 1, np.pi / 4],
                [0.1, 0, 0, 1, 1, 1, 0.3], [0, 0, 0, 1, 1, 1, 1.0]]
    r = np.asarray(jiou._bev_rects(jnp.asarray(corners(p))))[0]
    sub, clip = r[:, None], r[None, :]
    want = np.asarray(jax.jit(jax.vmap(jax.vmap(jiou._clip_quad_quad)))(
        jnp.broadcast_to(sub, (30, 30, 4, 2)),
        jnp.broadcast_to(clip, (30, 30, 4, 2))))
    got = clip_quad_quad_plain(torch.from_numpy(sub.copy()),
                               torch.from_numpy(clip.copy())).numpy()
    # a rotated quad against itself is ill-conditioned in both (module
    # docstring): off the diagonal, and the axis-aligned unit square's
    off = ~np.eye(30, dtype=bool)
    off[0, 0] = True
    np.testing.assert_allclose(got[off], want[off], rtol=0, atol=VALUE_ATOL)
    assert got[0, 0] == want[0, 0] == 1.0
    assert (want > 0).mean() > 0.2
    # the octagon of the unit square and its 45-degree turn
    assert got[0, 1] == pytest.approx(2 * (np.sqrt(2) - 1), rel=1e-6)


def test_cpu_takes_the_plain_version_and_counts_nothing():
    rng = np.random.RandomState(5)
    r1 = tiou._bev_rects(torch.from_numpy(corners(random_boxes(rng, 1, 6))))
    r2 = tiou._bev_rects(torch.from_numpy(corners(random_boxes(rng, 1, 4))))
    before = rotated_intersection_areas.launches
    gate = torch.rand(1, 6, 4) < 0.5
    out = rotated_intersection_areas(r1.requires_grad_(), r2, gate)
    out.sum().backward()
    assert rotated_intersection_areas.launches == before
    assert float(out[~gate].abs().sum()) == 0.0
    assert r1.grad is not None
