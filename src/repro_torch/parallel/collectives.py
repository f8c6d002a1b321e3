"""Collectives along one axis of a rank mesh: the port's counterparts of
the ``jax.lax`` collectives a ``shard_map`` body calls with an
``axis_name``, and a broadcast from one slot.

Each function takes this rank's tensor, a
:class:`~repro_torch.launch.mesh.RankMesh` and one of its axes, and runs
over the sub-group of this rank's line along that axis; every rank of
the line must call it, in the same order.  Slots are numbered along the
line as the mesh lays them out.  An axis is a name, a tuple of names
(the plane they span, its slots in row-major order, as a ``jax.lax``
collective takes a tuple ``axis_name``) or ``None``, the whole mesh.  A
line of one rank moves nothing: the result is a copy (or, for
``ppermute``, what the pairs say).  Nothing else in the port calls
``torch.distributed`` directly.

The sharded steps differentiate through six of them: :func:`gather_grad`
and :func:`scatter_grad` (an all-gather and a reduce-scatter, each the
other's transpose), Megatron's *f* and *g* (:func:`enter`,
:func:`leave`), and the sequence-parallel pair :func:`split_grad` (this
slot's chunk; the gradient all-gathered) and :func:`gather_keep` (an
all-gather; this slot's chunk of the gradient).  Each is an autograd
function, and over a line of one rank each is the identity (no copy),
so a step on a mesh of one rank computes what the unsharded step
computes, bit for bit.

:func:`count_collectives` records every collective issued inside it
(its kind, axis, payload bytes and line size) and each one's link
bytes under the ring model.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, Iterator, List, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["psum", "pmax", "all_gather", "all_to_all", "ppermute",
           "broadcast", "reduce_scatter", "gather_grad", "scatter_grad",
           "split_grad", "gather_keep", "enter", "leave", "line_size",
           "Collective", "count_collectives"]

Axis = Union[None, str, Tuple[str, ...]]

# all_gather_single and reduce_scatter_single replace the *_tensor
# forms, which newer torch deprecates
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter_into = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective a rank issued: ``kind`` (``all_reduce``,
    ``all_gather``, ``reduce_scatter``, ``all_to_all``, ``broadcast`` or
    ``send``), the ``axis`` it ran over, its payload ``nbytes`` (an
    all-reduce's tensor, an all-gather's whole output, a reduce-scatter's
    whole input, the tensor of the others), the ``slots`` of its line
    and the payload's ``shape``."""

    kind: str
    axis: Axis
    nbytes: int
    slots: int
    shape: Tuple[int, ...]

    @property
    def link_bytes(self) -> float:
        """The bytes a slot sends under the ring model (JAX's
        ``launch/hlo_stats.py``): an all-reduce 2 P (n - 1) / n, a send
        P, every other kind P (n - 1) / n."""
        if self.kind == "send":
            return float(self.nbytes)
        share = self.nbytes * (self.slots - 1) / self.slots
        return 2 * share if self.kind == "all_reduce" else share


# the open count_collectives blocks, each a list of records: a backward
# runs its collectives on the autograd engine's thread, which a context
# variable would not reach
_TALLIES: List[List[Collective]] = []


@contextlib.contextmanager
def count_collectives() -> Iterator[List[Collective]]:
    """Within the block, every collective this process issues (a line of
    one rank issues none) is appended to the list it yields, in the
    order issued, on any thread."""
    tally: List[Collective] = []
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        # by identity: two open tallies may hold equal records
        del _TALLIES[next(i for i, t in enumerate(_TALLIES) if t is tally)]


def _issued(kind: str, axis: Axis, t: torch.Tensor, slots: int) -> None:
    for tally in list(_TALLIES):
        tally.append(Collective(kind, axis, t.numel() * t.element_size(),
                                slots, tuple(t.shape)))


def _line(mesh, axis: Axis):
    """(group, ranks in slot order, slot order -> group order or None
    when the two agree)."""
    group, ranks = mesh.axis_group(axis)
    order = sorted(ranks)
    perm = None if list(ranks) == order else [order.index(r) for r in ranks]
    return group, ranks, perm


def _reduce(x: torch.Tensor, mesh, axis: Axis, op) -> torch.Tensor:
    group, ranks, _ = _line(mesh, axis)
    out = x.clone()
    if len(ranks) > 1:
        _issued("all_reduce", axis, out, len(ranks))
        dist.all_reduce(out, op=op, group=group)
    return out


def psum(x: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over the line (``jax.lax.psum``)."""
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the line
    (``jax.lax.pmax``)."""
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh, axis: Axis, dim: int = 0
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
        _issued("all_gather", axis, out, n)
        _gather_into(out, src, group=group)
        if perm is not None:
            out = out.view((n,) + tuple(src.shape))[perm].flatten(0, 1)
    return out.movedim(0, dim)


def all_to_all(x: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
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
    _issued("all_to_all", axis, out, n)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out if perm is None else out[perm]


def ppermute(x: torch.Tensor, mesh, axis: Axis,
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
            _issued("send", axis, x, len(ranks))
            ops.append(dist.P2POp(dist.isend, x.contiguous(), ranks[d]))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def broadcast(x: torch.Tensor, mesh, axis: Axis, src: int
              ) -> torch.Tensor:
    """Slot ``src``'s ``x`` on every slot of the line.  The other slots
    pass a tensor of the same shape and dtype, which is overwritten and
    returned."""
    group, ranks, _ = _line(mesh, axis)
    if len(ranks) > 1:
        x = x.contiguous()
        _issued("broadcast", axis, x, len(ranks))
        dist.broadcast(x, src=ranks[src], group=group)
    return x


def line_size(mesh, axis: Axis) -> int:
    """The slots of this rank's line along ``axis``."""
    return len(mesh.axis_group(axis)[1])


def reduce_scatter(x: torch.Tensor, mesh, axis: Axis,
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
    _issued("reduce_scatter", axis, src, n)
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


class _ScatterGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g, *ctx.args), None, None, None)


def _chunk(x: torch.Tensor, mesh, axis: Axis, dim: int) -> torch.Tensor:
    """This slot's chunk of ``x`` along ``dim``, in storage of its own."""
    n = line_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"{n} slots need dim {dim} divisible by {n}, got "
                         f"{tuple(x.shape)}")
    k = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis) * k, k).clone(
        memory_format=torch.contiguous_format)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _chunk(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g, *ctx.args), None, None, None)


class _GatherKeep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_chunk(g, *ctx.args), None, None, None)


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


def gather_grad(x: torch.Tensor, mesh, axis: Axis, dim: int = 0
                ) -> torch.Tensor:
    """:func:`all_gather` whose backward sums the gradient over the line
    and gives each slot its chunk (:func:`reduce_scatter`): FSDP's
    gather of a weight at use, and the gather of a projection's column
    shards.  ``x`` itself over a line of one."""
    if line_size(mesh, axis) == 1:
        return x
    return _GatherGrad.apply(x, mesh, axis, dim)


def scatter_grad(x: torch.Tensor, mesh, axis: Axis, dim: int = 0
                 ) -> torch.Tensor:
    """:func:`reduce_scatter` whose backward all-gathers the gradient:
    the slots' partial sums of one value, each slot keeping its chunk
    of the sum (Megatron's sequence-parallel *g*).  ``x`` itself over a
    line of one."""
    if line_size(mesh, axis) == 1:
        return x
    return _ScatterGrad.apply(x, mesh, axis, dim)


def split_grad(x: torch.Tensor, mesh, axis: Axis, dim: int = 0
               ) -> torch.Tensor:
    """This slot's chunk along ``dim`` of a value every slot holds whole,
    the gradient's chunks all-gathered back whole on every slot.
    ``x`` itself over a line of one."""
    if line_size(mesh, axis) == 1:
        return x
    return _Split.apply(x, mesh, axis, dim)


def gather_keep(x: torch.Tensor, mesh, axis: Axis, dim: int = 0
                ) -> torch.Tensor:
    """:func:`all_gather` whose backward keeps this slot's chunk of the
    gradient, for a whole value whose every slot's gradient is whole
    (its consumers' *f* has summed it over the line).  ``x`` itself over
    a line of one."""
    if line_size(mesh, axis) == 1:
        return x
    return _GatherKeep.apply(x, mesh, axis, dim)


def enter(x: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """Megatron's *f*: the identity forward, :func:`psum` of the
    gradient backward.  Put where a tensor that every slot of the line
    holds whole enters compute that each slot does on its own shard."""
    if line_size(mesh, axis) == 1:
        return x
    return _Enter.apply(x, mesh, axis)


def leave(x: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """Megatron's *g*: :func:`psum` forward, the identity backward.  Put
    where the slots' partial results of one value are summed."""
    if line_size(mesh, axis) == 1:
        return x
    return _Leave.apply(x, mesh, axis)
