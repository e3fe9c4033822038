"""The rotated GIoU's bird's-eye intersection areas: kernel R
(`csrc/rotated_iou.cu`) and its plain PyTorch version.

Not the port of a TPU kernel: the JAX criterion computes this function in
XLA, outside Pallas, as `vdetr_tpu/geometry/iou.py:_clip_quad_quad` (a
Sutherland-Hodgman clip of a prediction's quad by a ground-truth quad in
a fixed 16-vertex buffer: a `fori_loop` inside a `lax.scan`) vmapped over
every pair of every matching job. Under autograd a torch version of that
loop saves a few (pairs, 16, 2) tensors per vertex slot, ~8 GB a job at
the published width, so the port computes it in one kernel a call, and
its gradient in another.

`clip_quad_quad_plain(subject, clip)`: the plain version, the JAX loop
vectorized over pairs with the same buffer: the strict `>` inside test,
the intersection with `+ 1e-30` in its denominator, writes past the 16th
slot dropped and reads past it clamped, as JAX's scatter and gather do,
and the shoelace over the live vertices summed slot by slot, 0 below
three vertices. It differs from the JAX loop in one place only, where
the forward cannot see it: an intersection that is not appended takes a
denominator of 1, so that its zero cotangent stays zero (JAX multiplies
it by 1 / (den + 1e-30)^2, which is inf, and gets NaN, where a subject
edge is parallel to the clip edge).

`rotated_intersection_areas(rect1, rect2, gate)`: the entry the GIoU
calls. CPU tensors take the plain version (autograd differentiates it);
CUDA tensors launch kernel R forward, and its backward kernel for the
gradient in `rect1` (the ground truth is data: a `rect2` that requires
grad is refused). Both launches count on `rotated_intersection_areas.
launches`. On the card the forward is bit-equal to the plain version:
every operation is rounded alone, in the plain version's order.
"""

from __future__ import annotations

import torch

from vdetr_tpu_torch import kernels

MAXV = 16  # vertex slots while clipping a quad by a quad (8 needed)
# kernel R's flops: 5 a clip edge's constants, 5 an inside test of a live
# vertex, 18 an intersection, 4 a shoelace term, 2 the half and abs
EDGE_FLOPS, INSIDE_FLOPS, CROSS_FLOPS, SHOELACE_FLOPS = 5, 5, 18, 4


def clip_flops(work):
    """The flops of the clips whose `work` (live vertices visited,
    intersections appended, vertices left, each (...)) came from
    `clip_quad_quad_plain(..., work=True)`."""
    visited, crossed, left = work
    return (4 * EDGE_FLOPS + INSIDE_FLOPS * visited + CROSS_FLOPS * crossed
            + SHOELACE_FLOPS * left + 2)


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def _put(buf, slot, flag, v, slots):
    """buf (..., MAXV, 2) with v (..., 2) written at slot (...,) where
    flag: a slot >= MAXV writes nothing."""
    sel = (slots == slot[..., None]) & flag[..., None]
    return torch.where(sel[..., None], v[..., None, :], buf)


def _take(buf, slot):
    """buf (..., MAXV, 2) at slot (...,), clamped into the buffer."""
    idx = slot.clamp(0, MAXV - 1)[..., None, None].expand(
        slot.shape + (1, 2))
    return buf.gather(-2, idx)[..., 0, :]


def clip_quad_quad_plain(subject, clip, work: bool = False):
    """Intersection areas of quads `subject` (..., 4, 2) clipped by convex
    CCW quads `clip` (..., 4, 2), shapes broadcast -> (...). `work`: also
    the live vertices each clip visited, the intersections it appended
    and the vertices left, each (...) int64 (`clip_flops`)."""
    subject, clip = torch.broadcast_tensors(subject, clip)
    shape = subject.shape[:-2]
    dev = subject.device
    slots = torch.arange(MAXV, device=dev)
    poly = torch.cat([subject, subject.new_zeros(shape + (MAXV - 4, 2))],
                     -2)
    n = torch.full(shape, 4, dtype=torch.int64, device=dev)
    visited = torch.zeros_like(n)
    crossed = torch.zeros_like(n)
    for edge in range(4):
        visited = visited + n.clamp(max=MAXV)
        cp1 = clip[..., (edge + 3) % 4, :]
        cp2 = clip[..., edge, :]
        d = cp2 - cp1
        dc = -d
        n1 = cp1[..., 0] * cp2[..., 1] - cp1[..., 1] * cp2[..., 0]

        def inside(p):
            return (d[..., 0] * (p[..., 1] - cp1[..., 1])
                    > d[..., 1] * (p[..., 0] - cp1[..., 0]))

        out = torch.zeros_like(poly)
        m = torch.zeros_like(n)
        s = _take(poly, n - 1)
        for i in range(MAXV):
            valid = i < n
            e = poly[..., i, :]
            ins_e, ins_s = inside(e), inside(s)
            add_x = valid & (ins_e != ins_s)
            dp = s - e
            n2 = s[..., 0] * e[..., 1] - s[..., 1] * e[..., 0]
            den = dc[..., 0] * dp[..., 1] - dc[..., 1] * dp[..., 0] + 1e-30
            n3 = torch.reciprocal(torch.where(add_x, den, 1.0))
            x = torch.stack([(n1 * dp[..., 0] - n2 * dc[..., 0]) * n3,
                             (n1 * dp[..., 1] - n2 * dc[..., 1]) * n3], -1)
            out = _put(out, m, add_x, x, slots)
            m = m + add_x
            crossed = crossed + add_x
            add_e = valid & ins_e
            out = _put(out, m, add_e, e, slots)
            m = m + add_e
            s = torch.where(valid[..., None], e, s)
        poly, n = out, m
    # shoelace over the n live vertices, summed slot by slot
    x, y = poly[..., 0], poly[..., 1]
    nxt = torch.where(slots + 1 < n[..., None],
                      (slots + 1).clamp(max=MAXV - 1), 0)
    contrib = torch.where(slots < n[..., None],
                          x * y.gather(-1, nxt) - y * x.gather(-1, nxt), 0.0)
    total = contrib[..., 0]
    for i in range(1, MAXV):
        total = total + contrib[..., i]
    area = torch.where(n >= 3, 0.5 * total.abs(), 0.0)
    return (area, (visited, crossed, n.clamp(max=MAXV))) if work else area


def rotated_areas_plain(rect1, rect2, gate):
    """The plain version of kernel R: rect1 (B, K1, 4, 2), rect2 (B, K2,
    4, 2), gate (B, K1, K2) bool -> (B, K1, K2) areas, 0 where the gate is
    off."""
    areas = clip_quad_quad_plain(rect1[:, :, None], rect2[:, None, :])
    return torch.where(gate, areas, 0.0)


# --------------------------------------------------------------------------
# kernel R
# --------------------------------------------------------------------------

def _check(rect1, rect2, gate):
    B, K1 = rect1.shape[:2]
    K2 = rect2.shape[1]
    kernels.check(rect1, torch.float32, (B, K1, 4, 2), "rect1")
    kernels.check(rect2, torch.float32, (B, K2, 4, 2), "rect2")
    kernels.check(gate, torch.uint8, (B, K1, K2), "gate")
    return B, K1, K2


def rotated_areas_launch(rect1, rect2, gate):
    """Kernel R's forward on contiguous CUDA tensors: rect1 (B, K1, 4, 2)
    and rect2 (B, K2, 4, 2) float32, gate (B, K1, K2) uint8 -> (B, K1,
    K2) float32. Counts nothing."""
    B, K1, K2 = _check(rect1, rect2, gate)
    out = torch.empty(B, K1, K2, dtype=torch.float32, device=rect1.device)
    if out.numel():
        kernels.call("rotated_iou", rect1.data_ptr(), rect2.data_ptr(),
                     gate.data_ptr(), 0, out.data_ptr(), B, K1, K2, 0,
                     torch.cuda.current_stream(rect1.device).cuda_stream)
    return out


def rotated_areas_bwd_launch(rect1, rect2, gate, grad):
    """Kernel R's backward: d areas (B, K1, K2) -> d rect1 (B, K1, 4, 2),
    one warp a row, its pairs' gradients summed in column order. Counts
    nothing."""
    B, K1, K2 = _check(rect1, rect2, gate)
    kernels.check(grad, torch.float32, (B, K1, K2), "grad")
    d1 = torch.empty_like(rect1)
    if d1.numel():
        kernels.call("rotated_iou", rect1.data_ptr(), rect2.data_ptr(),
                     gate.data_ptr(), grad.data_ptr(), d1.data_ptr(), B, K1,
                     K2, 1, torch.cuda.current_stream(rect1.device).cuda_stream)
    return d1


class _RotatedAreas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rect1, rect2, gate):
        out = rotated_areas_launch(rect1, rect2, gate)
        rotated_intersection_areas.launches += 1
        ctx.save_for_backward(rect1, rect2, gate)
        return out

    @staticmethod
    def backward(ctx, grad):
        rect1, rect2, gate = ctx.saved_tensors
        d1 = rotated_areas_bwd_launch(rect1, rect2, gate,
                                      grad.float().contiguous())
        rotated_intersection_areas.launches += 1
        return d1, None, None


def rotated_intersection_areas(rect1, rect2, gate):
    """Bird's-eye intersection areas of every pair: rect1 (B, K1, 4, 2)
    predictions, rect2 (B, K2, 4, 2) ground truth (CCW), gate (B, K1, K2)
    bool -> (B, K1, K2), 0 where the gate is off. CUDA tensors launch
    kernel R (or raise); CPU tensors take the plain version."""
    if not rect1.is_cuda:
        return rotated_areas_plain(rect1, rect2, gate)
    if rect2.requires_grad:
        raise ValueError("kernel R differentiates the predictions only; "
                         "the ground-truth rects must not require grad")
    return _RotatedAreas.apply(rect1.float().contiguous(),
                               rect2.float().contiguous(),
                               gate.to(torch.uint8).contiguous())


rotated_intersection_areas.launches = 0
