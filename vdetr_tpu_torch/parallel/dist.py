"""One process per card, the reference's recipe (torch counterpart of
`vdetr_tpu/parallel/mesh.py`; reference utils/dist.py).

The JAX package runs its data-parallel step as one program under
`shard_map` over a "data" mesh axis; here each card has its own process
and the ranks meet in a `torch.distributed` process group: NCCL between
CUDA ranks, gloo between CPU ranks (and between ranks that share one
card, which NCCL refuses). The functions take the group explicitly;
`None` means one process and no group, where each of them is the
identity (rank 0 of a world of 1) and runs no collective.

Rank r of a world of n holds rows [r b, (r + 1) b) of a global batch of
n b rows (`rows`), as `shard_map` shards dim 0 over the mesh.

The JAX package's two-axis mesh `make_mesh(("data", "seq"), (D, S))` is
a `Grid` here (`make_grid`): rank r of a world of D S is (d, s) with
r = d S + s, the row-major order of the mesh's devices; the data group
holds the ranks of one s, the seq group those of one d. A world of 1, or
S = 1, has no seq group, and then every seq function is the dense one.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this raises (gloo) or aborts the
# process (NCCL's watchdog), so one rank's failure does not leave the
# others blocked for ever; an eval pass's AP on rank 0 (27 s for the 312
# ScanNet val scans) fits many times over
TIMEOUT = datetime.timedelta(minutes=30)


def init(rank: int, world: int, init_method: str, backend: str,
         timeout: datetime.timedelta = TIMEOUT):
    """Join the default process group as `rank` of `world` at
    `init_method` ("env://", "tcp://host:port" or "file://path") over
    `backend` ("nccl" or "gloo"). Returns the group. Raises when the
    rendezvous fails or times out."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)
    return dist.group.WORLD


def init_from_env(device) -> Optional[dist.ProcessGroup]:
    """The group that `torchrun` (or any launcher that sets RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT) asks for: None
    when WORLD_SIZE is unset or 1. On a CUDA `device` the rank takes card
    LOCAL_RANK (`torch.cuda.set_device`) and the group NCCL; on the CPU
    gloo."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    rank = int(os.environ["RANK"])
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank())
        backend = "nccl"
    else:
        backend = "gloo"
    return init(rank, world, "env://", backend)


def local_rank() -> int:
    """This process's card on its host (LOCAL_RANK; 0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def destroy(group) -> None:
    if group is not None:
        dist.destroy_process_group()


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def barrier(group) -> None:
    if group is not None:
        dist.barrier(group)


def rows(n: int, rank: int, world: int) -> slice:
    """The rows of a global batch of `n` that rank `rank` of `world`
    holds; `n` must divide evenly."""
    if n % world:
        raise ValueError(f"a global batch of {n} does not split over "
                         f"{world} ranks")
    b = n // world
    return slice(rank * b, (rank + 1) * b)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, differentiable: the backward sums the
    cotangents over the ranks, the transpose of JAX's psum. Each rank's
    loss depends on every rank's input through the sum, and the gradients
    averaged over the ranks afterwards are then those of the mean of the
    ranks' losses, as under `shard_map` (sync-BN's statistics)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over the ranks of `group` (differentiable; `x` itself
    when `group` is None)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def all_reduce_mean(tensors: Dict[str, torch.Tensor], group
                    ) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of each scalar of `tensors` (detached; one
    all-reduce of them packed; JAX's pmean: the sum, then the quotient by
    the world size). `tensors` itself when `group` is None."""
    if group is None:
        return tensors
    packed = torch.stack([v.detach().reshape(()).float()
                          for v in tensors.values()])
    dist.all_reduce(packed, group=group)
    packed = packed / world(group)
    return dict(zip(tensors, packed.unbind()))


def all_gather(tensors: Dict[str, torch.Tensor], group
               ) -> Dict[str, torch.Tensor]:
    """Each tensor of `tensors` (the same shapes on every rank) from every
    rank, concatenated along dim 0 in rank order; one all-gather a tensor.
    `tensors` itself when `group` is None."""
    if group is None:
        return tensors
    out = {}
    for k, t in tensors.items():
        t = t.contiguous()
        flag = t.dtype == torch.bool  # gloo gathers no bools
        if flag:
            t = t.to(torch.uint8)
        parts = [torch.empty_like(t) for _ in range(world(group))]
        dist.all_gather(parts, t, group=group)
        out[k] = torch.cat(parts).bool() if flag else torch.cat(parts)
    return out


def broadcast_object(obj, group, src: int = 0):
    """Rank `src`'s `obj` (picklable) on every rank; `obj` itself when
    `group` is None."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `x` over the ranks of `group` (not
    differentiable; `x` itself when `group` is None)."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


class _AllGather(torch.autograd.Function):
    """Every rank's `x` (one shape on every rank) concatenated along
    `dim` in rank order, differentiable: the backward sums the cotangents
    over the ranks and keeps this rank's slice, the transpose of JAX's
    tiled all_gather."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        x = x.contiguous()
        flag = x.dtype == torch.bool  # gloo gathers no bools
        parts = [torch.empty_like(x.to(torch.uint8) if flag else x)
                 for _ in range(world(group))]
        dist.all_gather(parts, x.to(torch.uint8) if flag else x, group=group)
        out = torch.cat(parts, dim=dim)
        return out.bool() if flag else out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        r = rank(ctx.group)
        return grad.narrow(ctx.dim, r * ctx.size, ctx.size), None, None


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """`x` of every rank of `group` concatenated along `dim` in rank
    order (differentiable; `x` itself when `group` is None)."""
    return x if group is None else _AllGather.apply(x, dim, group)


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Rank `src` (of `group`)'s `x` on every rank of `group` (`x` itself
    when `group` is None)."""
    if group is None:
        return x
    flag = x.dtype == torch.bool
    x = (x.to(torch.uint8) if flag else x).contiguous().clone()
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x.bool() if flag else x


class Grid(NamedTuple):
    """The ranks as a (data, seq) grid: rank (d, s) of D x S."""

    D: int
    S: int
    d: int
    s: int
    world: Optional[dist.ProcessGroup]  # every rank (DDP, sync-BN)
    # the ranks of this s: the world when S = 1, None when D = 1 < S
    data: Optional[dist.ProcessGroup]
    seq: Optional[dist.ProcessGroup]    # the ranks of this d (None: S = 1)


def mesh_dims(axis_names: Sequence[str], shape: Sequence[int],
              n: int) -> Tuple[int, int]:
    """(D, S) of the JAX package's mesh fields on a world of `n` ranks:
    a -1 takes what the others leave, as `make_mesh` does; an axis that
    is absent has size 1. Raises for another axis name or a product that
    is not the world (`make_mesh` would take fewer devices; here every
    rank must have its place)."""
    names, shape = tuple(axis_names), list(shape)
    if len(names) != len(shape) or set(names) - {"data", "seq"}:
        raise ValueError(f"mesh {names} {tuple(shape)}: want the axes "
                         "'data' and/or 'seq', one size each")
    if -1 in shape:
        known = int(np.prod([x for x in shape if x != -1])) or 1
        shape[shape.index(-1)] = n // known
    dims = dict(zip(names, shape))
    D, S = dims.get("data", 1), dims.get("seq", 1)
    if D * S != n or D < 1 or S < 1:
        raise ValueError(f"mesh {names} {tuple(shape)} is {D} x {S} ranks, "
                         f"but the world has {n}")
    return D, S


def make_grid(group, D: int, S: int) -> Grid:
    """The (D, S) grid of the ranks of `group` (the world; None: one
    process). Every rank must call this at the same point: each creates
    every subgroup, in the same order (`dist.new_group`)."""
    n, r = world(group), rank(group)
    if D * S != n:
        raise ValueError(f"a {D} x {S} grid needs {D * S} ranks, not {n}")
    d, s = divmod(r, S)
    data = seq = None
    if group is not None and S > 1:
        for dd in range(D):
            g = dist.new_group([dd * S + ss for ss in range(S)])
            seq = g if dd == d else seq
        if D > 1:
            for ss in range(S):
                g = dist.new_group([dd * S + ss for dd in range(D)])
                data = g if ss == s else data
    else:
        data = group
    return Grid(D, S, d, s, group, data, seq)
