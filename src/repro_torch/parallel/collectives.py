"""Collectives along one axis of a rank mesh: the port's counterparts of
the ``jax.lax`` collectives a ``shard_map`` body calls with an
``axis_name``, and a broadcast from one slot.

Each function takes this rank's tensor, a
:class:`~repro_torch.launch.mesh.RankMesh` and one of its axes, and runs
over the sub-group of this rank's line along that axis; every rank of
the line must call it, in the same order.  Slots are numbered along the
line as the mesh lays them out.  Axis ``None`` is the whole mesh, its
slots in row-major order.  A line of one rank moves nothing: the
result is a copy (or, for ``ppermute``, what the pairs say).  Nothing
else in the port calls ``torch.distributed`` directly.

The sharded steps differentiate through four of them
(:func:`gather_grad`, :func:`reduce_scatter`, and Megatron's two
operators :func:`enter` (*f*) and :func:`leave` (*g*)): each is an
autograd function whose backward is the collective that transposes
its forward, and over a line of one rank each is the identity (no
copy), so a step on a mesh of one rank computes what the unsharded
step computes, bit for bit.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["psum", "pmax", "all_gather", "all_to_all", "ppermute",
           "broadcast", "reduce_scatter", "gather_grad", "enter", "leave",
           "line_size"]

# all_gather_single and reduce_scatter_single replace the *_tensor
# forms, which newer torch deprecates
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter_into = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _line(mesh, axis: Optional[str]):
    """(group, ranks in slot order, slot order -> group order or None
    when the two agree)."""
    group, ranks = mesh.axis_group(axis)
    order = sorted(ranks)
    perm = None if list(ranks) == order else [order.index(r) for r in ranks]
    return group, ranks, perm


def _reduce(x: torch.Tensor, mesh, axis: Optional[str], op
            ) -> torch.Tensor:
    group, ranks, _ = _line(mesh, axis)
    out = x.clone()
    if len(ranks) > 1:
        dist.all_reduce(out, op=op, group=group)
    return out


def psum(x: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """The sum of ``x`` over the line (``jax.lax.psum``)."""
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the line
    (``jax.lax.pmax``)."""
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh, axis: Optional[str], dim: int = 0
               ) -> torch.Tensor:
    """Every slot's ``x`` concatenated along ``dim`` in slot order
    (``jax.lax.all_gather(..., tiled=True)``)."""
    group, ranks, perm = _line(mesh, axis)
    n = len(ranks)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    if n == 1:
        out.copy_(src)
    else:
        _gather_into(out, src, group=group)
        if perm is not None:
            out = out.view((n,) + tuple(src.shape))[perm].flatten(0, 1)
    return out.movedim(0, dim)


def all_to_all(x: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """``x`` (n, ...) over a line of n slots: chunk ``j`` goes to slot
    ``j``, and chunk ``j`` of the result came from slot ``j``
    (``jax.lax.all_to_all(x, axis, 0, 0, tiled=False)``)."""
    group, ranks, perm = _line(mesh, axis)
    n = len(ranks)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {n} slots needs a leading dim "
                         f"of {n}, got {tuple(x.shape)}")
    if n == 1:
        return x.clone()
    if perm is not None:        # chunks in group order
        x = x[[perm.index(i) for i in range(n)]]
    out = torch.empty_like(x.contiguous())
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out if perm is None else out[perm]


def ppermute(x: torch.Tensor, mesh, axis: Optional[str],
             pairs: Iterable[Tuple[int, int]]) -> torch.Tensor:
    """Slot ``s``'s ``x`` lands at slot ``d`` for each (s, d) of
    ``pairs``; a slot that receives nothing gets zeros
    (``jax.lax.ppermute``)."""
    _, ranks, _ = _line(mesh, axis)
    me = ranks.index(mesh.rank)
    pairs = [(int(s) % len(ranks), int(d) % len(ranks)) for s, d in pairs]
    out = torch.zeros_like(x)
    ops = []
    for s, d in pairs:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), ranks[d]))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def broadcast(x: torch.Tensor, mesh, axis: Optional[str], src: int
              ) -> torch.Tensor:
    """Slot ``src``'s ``x`` on every slot of the line.  The other slots
    pass a tensor of the same shape and dtype, which is overwritten and
    returned."""
    group, ranks, _ = _line(mesh, axis)
    if len(ranks) > 1:
        x = x.contiguous()
        dist.broadcast(x, src=ranks[src], group=group)
    return x


def line_size(mesh, axis: Optional[str]) -> int:
    """The slots of this rank's line along ``axis``."""
    return len(mesh.axis_group(axis)[1])


def reduce_scatter(x: torch.Tensor, mesh, axis: Optional[str],
                   dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over the line, cut into as many chunks along
    ``dim`` as the line has slots; slot ``i`` keeps chunk ``i``
    (``jax.lax.psum_scatter(..., tiled=True)``)."""
    group, ranks, perm = _line(mesh, axis)
    n = len(ranks)
    src = x.movedim(dim, 0)
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter over {n} slots needs dim {dim} "
                         f"divisible by {n}, got {tuple(x.shape)}")
    if n == 1:
        return src.clone().movedim(0, dim)
    if perm is not None:        # chunks in group order
        src = src.reshape((n, -1) + tuple(src.shape[1:]))[
            [perm.index(i) for i in range(n)]].flatten(0, 1)
    src = src.contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _scatter_into(out, src, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


class _GatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, *ctx.args), None, None, None)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, *ctx.args), None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather_grad(x: torch.Tensor, mesh, axis: Optional[str], dim: int = 0
                ) -> torch.Tensor:
    """:func:`all_gather` whose backward sums the gradient over the line
    and gives each slot its chunk (:func:`reduce_scatter`): FSDP's
    gather of a weight at use, and the gather of a projection's column
    shards.  ``x`` itself over a line of one."""
    if line_size(mesh, axis) == 1:
        return x
    return _GatherGrad.apply(x, mesh, axis, dim)


def enter(x: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """Megatron's *f*: the identity forward, :func:`psum` of the
    gradient backward.  Put where a tensor that every slot of the line
    holds whole enters compute that each slot does on its own shard."""
    if line_size(mesh, axis) == 1:
        return x
    return _Enter.apply(x, mesh, axis)


def leave(x: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """Megatron's *g*: :func:`psum` forward, the identity backward.  Put
    where the slots' partial results of one value are summed."""
    if line_size(mesh, axis) == 1:
        return x
    return _Leave.apply(x, mesh, axis)
