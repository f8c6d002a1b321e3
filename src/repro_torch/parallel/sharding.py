"""Sharding rules: parameter and cache leaf names -> partition specs (the
port's counterpart of ``repro.parallel.sharding``).

Axes (``launch/mesh.py``):
  * ``pod``   — data parallel across pods (multi-pod mesh only)
  * ``data``  — data parallel + FSDP (params' non-model dim)
  * ``model`` — tensor parallel (heads / ffn / vocab / experts)

The rules are pure functions of leaf names, shapes and the mesh's axis
sizes.  They return the port's :class:`PartitionSpec`, a tuple of one
axis name, tuple of axis names or ``None`` per dimension, equal entry
for entry to JAX's ``PartitionSpec`` for the same leaves.  Parameters
are keyed by JAX's leaf paths through ``models/convert.py``'s
``reference_key``, so a layer's leaf is ruled at JAX's stacked shape
``(count, ...)`` and its spec starts with the layer dimension.

:func:`place` puts a tree on an engine mesh.  On a mesh of logical
devices every leaf goes whole to the one physical device the mesh names
(an engine mesh over several physical devices raises: one engine over
several devices runs on a rank mesh, whose collectives move its shards).
On a :class:`~repro_torch.launch.mesh.RankMesh` each rank keeps only its
shard of each leaf, by the specs :func:`param_shardings` or
:func:`cache_shardings` give, on its own device.

The paged pool sharded on ``data`` (JAX's ``_pool_constraint``): inside
:func:`pool_shards`, a layer's decode all-gathers its pool shards into
one full ``(NP, ...)`` buffer (:func:`gather_pool`), writes and attends
it as one device would, and keeps its own slice back in its shard
(:func:`keep_shard`).  That is what GSPMD does with the reference's
unpartitioned Pallas call, so the result is bit-identical to one device.

One sharded step's shards (:class:`StepShards`, entered with
:func:`step_shards`): the sharded steps of ``launch/steps.py`` hand the
models parameters cut by :func:`param_shardings` over ``data`` (FSDP)
and ``model`` (tensor parallelism).  Inside the block, :func:`use`
all-gathers a leaf's ``data`` cut at each use (its backward
reduce-scatters the gradient), :func:`model_cut` says where ``model``
cuts a leaf, and :func:`tp_enter` / :func:`tp_leave` are Megatron's *f*
and *g* over ``model``.  The batch rows are cut over ``data``, or over
the ``("pod", "data")`` plane of a mesh with a ``pod`` axis (parameters
are replicated over ``pod``).  Outside it every one of them is the
identity, and an axis of one slot never counts as a cut, so a step on a
(1, 1) or (1, 1, 1) mesh computes what the unsharded step computes, bit
for bit.

The sequence-parallel residual stream (``cfg.act_sp``, Megatron's
sequence parallelism): inside :func:`residual_stream` a step that asks
for it holds the stream (B, S, D) of the cache-free forward, the encoder
or the teacher-forced decoder as this rank's S / ``model`` tokens, when
``model`` divides S.  Each sublayer's input is normed on those tokens
and gathered whole (:func:`stream_norm` in ``models/common.py``, through
:func:`stream_gather`), and its output comes back to the rank's tokens
through :func:`tp_out`: a partial sum over ``model`` is reduce-scattered
where it would have been all-reduced, a value every rank holds whole is
narrowed.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from repro_torch.launch.mesh import RankMesh
from repro_torch.parallel.collectives import (all_gather, enter,
                                              gather_grad, gather_keep,
                                              leave, line_size, psum,
                                              scatter_grad, split_grad)


class PartitionSpec(tuple):
    """Per-dimension placement: an axis name, a tuple of them, or None
    (replicated).  ``PartitionSpec("data", None)`` equals
    ``("data", None)``."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    fsdp: bool = True            # shard params' other big dim over `data`
    seq_shard_cache: bool = True  # shard decode KV caches over `data` (SP)

    def dp_axes(self, mesh):
        axes = tuple(n for n in ("pod", "data") if n in mesh.axis_names)
        return axes if len(axes) > 1 else (axes[0] if axes else None)


# param names that are column-parallel (model on last/output dim)
_COL = ("wq", "wk", "wv", "w_gate", "w_up", "w_uq", "w_uk", "w_uv",
        "wr", "wg", "w_in", "w_dt", "w_lora_b", "w_bcdt_T")
# row-parallel (model on first/input dim)
_ROW = ("wo", "w_down", "w_out", "wv_chan")
# per-output-dim 1-D params
_COL_BIAS = ("bq", "bk", "bv", "conv_b", "dt_bias", "d_skip")
# paged KV pool leaves: stacked (layer_count, n_pages, ...); dim 1 is
# the page-pool dim, the unit the paged serve loop allocates/migrates
_PAGED_POOL = ("kp", "vp", "ckvp", "krp")


def _divisible(n: int, mesh, axis: str) -> bool:
    return axis in mesh.axis_names and n % mesh.shape[axis] == 0


def param_pspec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
                rules: ShardingRules) -> PartitionSpec:
    """The spec of the parameter leaf at JAX's ``path`` (its names, list
    indices as strings) of JAX's ``shape``."""
    name = path[-1] if path else ""

    def spec(*dims):
        dims = list(dims)
        # pad to shape rank with leading None (layer-stack dims)
        while len(dims) < len(shape):
            dims.insert(0, None)
        # drop shardings that do not divide
        out = []
        for size, d in zip(shape[-len(dims):] if len(dims) == len(shape)
                           else shape, dims):
            if d is None:
                out.append(None)
            elif isinstance(d, str):
                out.append(d if _divisible(size, mesh, d) else None)
            else:
                sub = tuple(a for a in d if a in mesh.axis_names)
                tot = 1
                for a in sub:
                    tot *= mesh.shape[a]
                out.append(d if (sub == d and size % tot == 0) else None)
        return P(*out)

    fs = "data" if rules.fsdp else None

    if name == "embed":
        return spec("model", fs)
    if name == "unembed":
        return spec(fs, "model")
    if name == "router":
        return spec(None, None)
    is_expert = ("moe" in path and "shared" not in path
                 and name in ("w_gate", "w_up", "w_down"))
    if is_expert:
        # expert tensors (E, D, F): expert parallelism
        return spec("model", fs, None)
    if name in _COL:
        return spec(fs, "model")
    if name in _ROW:
        return spec("model", fs)
    if name in _COL_BIAS:
        return spec("model")
    if name == "conv_w":
        return spec(None, "model")
    if name in ("a_log", "u_bonus"):
        return spec("model", None)
    # norms, mixes, small latent projections: replicated
    return P(*([None] * len(shape)))


def param_shardings(params, mesh, rules: Optional[ShardingRules] = None
                    ) -> Dict[str, NamedSharding]:
    """Each parameter of ``params`` (a module, or tensors keyed by its
    parameter names) -> its sharding, ruled on JAX's leaf: a layer's
    tensor at its segment stack's shape ``(count, ...)``."""
    # imported here: the models import this package's pool helpers
    from repro_torch.models.convert import named, reference_key
    rules = rules or ShardingRules()
    tensors = named(params)
    keys = {name: reference_key(name) for name in tensors}
    rows: Dict[Tuple, int] = {}
    for path, row in keys.values():
        if row is not None:
            rows[path] = rows.get(path, 0) + 1
    out = {}
    for name, t in tensors.items():
        path, row = keys[name]
        shape = tuple(t.shape)
        if row is not None:
            shape = (rows[path],) + shape
        out[name] = NamedSharding(mesh, param_pspec(
            tuple(str(p) for p in path), shape, mesh, rules))
    return out


def batch_sharding(mesh, ndim: int, rules: Optional[ShardingRules] = None
                   ) -> NamedSharding:
    """Shard the leading (batch) dim over pod x data."""
    rules = rules or ShardingRules()
    dp = rules.dp_axes(mesh)
    return NamedSharding(mesh, P(dp, *([None] * (ndim - 1))))


def _tree_map(fn, tree, names=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, names + (str(i),))
                          for i, v in enumerate(tree))
    return fn(names, tree)


def cache_shardings(cache, mesh, rules: Optional[ShardingRules] = None,
                    batch: int = 0) -> Any:
    """KV caches: batch over pod+data when divisible, else sequence over
    data (sequence parallelism for long-context decode).  Paged pool
    leaves shard their page dim over ``data`` (pages are
    batch-agnostic, so the batch rule never applies to them) and fall
    back to replication — never sequence sharding, which would split
    inside a page."""
    rules = rules or ShardingRules()
    dp = rules.dp_axes(mesh)
    dp_size = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            dp_size *= mesh.shape[a]

    def f(names, leaf):
        shape = tuple(leaf.shape)
        if names and names[-1] in _PAGED_POOL and len(shape) >= 3:
            if _divisible(shape[1], mesh, "data"):
                return NamedSharding(
                    mesh, P(None, "data", *([None] * (len(shape) - 2))))
            return NamedSharding(mesh, P(*([None] * len(shape))))
        # leading dims: (layers, batch, ...) after stacking
        if len(shape) >= 3:
            b = shape[1]
            if b % dp_size == 0 and b > 0:
                return NamedSharding(
                    mesh, P(None, dp, *([None] * (len(shape) - 2))))
            # sequence-parallel fallback: shard the time axis over data
            if names and names[-1] in ("k", "v") and len(shape) == 5:
                if rules.seq_shard_cache and _divisible(shape[3], mesh,
                                                        "data"):
                    return NamedSharding(
                        mesh, P(None, None, None, "data", None))
            if names and names[-1] in ("ckv", "kr") and len(shape) == 4:
                if rules.seq_shard_cache and _divisible(shape[2], mesh,
                                                        "data"):
                    return NamedSharding(mesh, P(None, None, "data", None))
        return NamedSharding(mesh, P(*([None] * len(shape))))

    return _tree_map(f, cache)


def page_table_sharding(mesh, batch: int,
                        rules: Optional[ShardingRules] = None
                        ) -> NamedSharding:
    """Page tables (B, npb) int32: batch over pod+data when divisible,
    else replicated (tables are tiny; replication is never wrong)."""
    rules = rules or ShardingRules()
    dp = rules.dp_axes(mesh)
    dp_size = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            dp_size *= mesh.shape[a]
    if dp is not None and batch > 0 and batch % dp_size == 0:
        return NamedSharding(mesh, P(dp, None))
    return NamedSharding(mesh, P(None, None))


# -- placement ---------------------------------------------------------------


def engine_device(mesh) -> torch.device:
    """The device an engine mesh runs on: on a rank mesh this rank's; on
    a mesh of logical devices the one physical device its slots name
    (several raise, see the module docstring)."""
    if isinstance(mesh, RankMesh):
        return mesh.device
    devs = mesh.physical_devices()
    if len(devs) != 1:
        raise NotImplementedError(
            f"engine mesh {mesh} spans {len(devs)} physical devices in one "
            "process; one engine over several devices runs on a rank mesh "
            "(make_serve_meshes(..., ranks=True)), whose collectives move "
            "its shards")
    return devs[0]


def _module_on(module: nn.Module, device: torch.device,
               shard=None) -> nn.Module:
    """``module`` itself when every tensor is on ``device`` and whole,
    else a copy there, each parameter cut by ``shard(name, tensor)``
    (``nn.Module.to`` would move the original in place); a cut
    parameter is copied into storage of its own, so the whole one can
    be freed."""
    params = dict(module.named_parameters())
    cut = {n: (shard(n, p) if shard else p) for n, p in params.items()}
    tensors = list(cut.values()) + list(module.buffers())
    if all(t.device == device for t in tensors) and all(
            cut[n] is params[n] for n in params):
        return module
    memo = {}
    for n, p in params.items():
        t = cut[n].detach().to(device)
        if cut[n] is not p:       # a shard in storage of its own
            t = t.clone(memory_format=torch.contiguous_format)
        memo[id(p)] = nn.Parameter(t, requires_grad=p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = b.to(device)
    return copy.deepcopy(module, memo)


def shard_of(t: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` on the rank mesh
    ``mesh`` (a view; ``t`` itself where the spec replicates).  A spec
    one entry longer than ``t`` is a layer leaf's, ruled at the stacked
    shape: its first entry, the layer dimension, is dropped."""
    spec = tuple(spec)
    if len(spec) == t.dim() + 1:
        spec = spec[1:]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, idx = 1, 0
        for a in axes:
            size = mesh.shape[a]
            n, idx = n * size, idx * size + mesh.axis_index(a)
        if n > 1:
            step = t.shape[dim] // n
            t = t.narrow(dim, idx * step, step)
    return t


def place(tree, mesh, shardings=None):
    """``tree`` (a module, or dicts and lists of tensors) on ``mesh``.

    On a mesh of logical devices every leaf goes whole to its device; a
    leaf already there is returned as it is.  On a rank mesh each leaf is
    cut to this rank's shard by ``shardings`` (:func:`param_shardings`'
    dict for a module, :func:`cache_shardings`' tree otherwise; ``None``
    replicates every leaf) and put on this rank's device; a rank the mesh
    does not hold gets ``None``."""
    dev = engine_device(mesh)
    if not isinstance(mesh, RankMesh):
        if isinstance(tree, nn.Module):
            return _module_on(tree, dev)
        return _tree_map(lambda _, t: t.to(dev), tree)
    if not mesh.member:
        return None
    if isinstance(tree, nn.Module):
        return _module_on(tree, dev, None if shardings is None else (
            lambda name, t: shard_of(t, shardings[name].spec, mesh)))
    if shardings is None:
        return _tree_map(lambda _, t: t.to(dev), tree)

    def put(names, t):
        sh = shardings
        for k in names:
            sh = sh[int(k) if isinstance(sh, (list, tuple)) else k]
        block = shard_of(t, sh.spec, mesh)
        # a cut leaf is copied, so the whole leaf can be freed
        return block.to(dev, copy=block is not t)
    return _tree_map(put, tree)


# -- the paged pool sharded over an engine's rank mesh ----------------------

_POOL_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "pool_mesh", default=None)


@contextlib.contextmanager
def pool_shards(mesh) -> Iterator[None]:
    """Within the block, the paged pool leaves a model is given hold this
    rank's page shard over ``cfg.mesh_pool_axis`` of the rank mesh
    ``mesh``, and :func:`gather_pool` all-gathers them.  The serving loop
    enters it around an engine's step when the pool's spec shards."""
    token = _POOL_MESH.set(mesh)
    try:
        yield
    finally:
        _POOL_MESH.reset(token)


def gather_pool(cfg, pages: torch.Tensor) -> torch.Tensor:
    """One layer's pool shard ``(NP / n, ...)`` -> the whole ``(NP,
    ...)`` pool, all-gathered over ``cfg.mesh_pool_axis`` inside
    :func:`pool_shards` (over a line of one rank, a copy); elsewhere
    ``pages`` itself."""
    mesh = _POOL_MESH.get()
    if cfg.mesh_pool_axis is None or mesh is None:
        return pages
    return all_gather(pages, mesh, cfg.mesh_pool_axis)


def keep_shard(cfg, pages: torch.Tensor, full: torch.Tensor) -> None:
    """Copy this rank's slice of the whole pool ``full`` (from
    :func:`gather_pool`, written since) back into its shard ``pages``;
    nothing when ``full`` is ``pages``."""
    if full is pages:
        return
    i = _POOL_MESH.get().axis_index(cfg.mesh_pool_axis)
    n = pages.shape[0]
    pages.copy_(full[i * n:(i + 1) * n])


# -- one sharded step's shards ------------------------------------------------

_STEP: contextvars.ContextVar = contextvars.ContextVar("step_shards",
                                                       default=None)


@dataclasses.dataclass
class StepShards:
    """A sharded step's view of its rank mesh: ``cuts`` maps each
    parameter tensor it was given (by ``id``) to ``{axis: dim}``, the
    dimensions of the tensor as this rank holds it that an axis of more
    than one slot cuts (the layer dimension of JAX's stacked spec
    dropped).  ``batch_axis`` is the axis, or the tuple of axes, the
    batch rows are cut over (``None``: every rank holds every row),
    ``cache_seq_axis`` the axis the contiguous caches' sequence is cut
    over (JAX's ``cache_shardings`` fallback when the batch does not
    divide).  ``act_sp``: the step cuts its residual stream along the
    tokens where it can (:func:`residual_stream`), which then sets
    ``tokens_cut`` for the stream in flight."""

    mesh: RankMesh
    cuts: Dict[int, Dict[Any, int]]
    batch_axis: Any = None
    cache_seq_axis: Optional[str] = None
    act_sp: bool = False
    tokens_cut: bool = False

    def cut(self, t: torch.Tensor, axis: str) -> Optional[int]:
        return self.cuts.get(id(t), {}).get(axis)

    def axes(self, t: torch.Tensor) -> Tuple[Any, ...]:
        return tuple(self.cuts.get(id(t), {}))

    def lines(self, axis) -> int:
        return 1 if axis is None else line_size(self.mesh, axis)


def leaf_cuts(specs: Dict[str, NamedSharding], params, mesh
              ) -> Dict[int, Dict[str, int]]:
    """``{id(tensor): {axis: dim}}`` for the parameters of ``params``
    (a module, or tensors keyed by its names) under ``specs``
    (:func:`param_shardings` of the whole model), axes of one slot
    left out; a dimension cut over several axes is keyed by the tuple of
    those of more than one slot (by the axis, where one is left)."""
    from repro_torch.models.convert import named
    out = {}
    for name, t in named(params).items():
        spec = tuple(specs[name].spec)
        if len(spec) == t.dim() + 1:       # a layer leaf's stacked spec
            spec = spec[1:]
        cut = {}
        for dim, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            axes = tuple(a for a in axes if mesh.shape[a] > 1)
            if axes:
                cut[axes[0] if len(axes) == 1 else axes] = dim
        out[id(t)] = cut
    return out


@contextlib.contextmanager
def step_shards(shards: StepShards) -> Iterator[StepShards]:
    """Within the block the models compute on ``shards``' parameter
    shards (module docstring)."""
    token = _STEP.set(shards)
    try:
        yield shards
    finally:
        _STEP.reset(token)


def current_shards() -> Optional[StepShards]:
    return _STEP.get()


def in_current_shards(fn):
    """``fn``, entering the current step's shards itself when called (the
    identity outside a step): a layer that backward recomputes runs on
    the card's autograd thread, which does not see this thread's
    context."""
    shards = _STEP.get()
    if shards is None:
        return fn

    def run(*args):
        with step_shards(shards):
            return fn(*args)
    return run


def use(t: torch.Tensor) -> torch.Tensor:
    """A parameter as a step computes with it: gathered whole over
    ``data`` when FSDP cuts it (the gradient reduce-scattered back),
    still cut over ``model``; ``t`` itself elsewhere."""
    sh = _STEP.get()
    dim = None if sh is None else sh.cut(t, "data")
    if dim is None:
        return t
    return gather_grad(t, sh.mesh, "data", dim)


def model_cut(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """``(dim, slots, this rank's slot)`` where ``model`` cuts the
    parameter ``t``; ``None`` outside a sharded step or where it does
    not (JAX's rules drop a cut that does not divide)."""
    sh = _STEP.get()
    dim = None if sh is None else sh.cut(t, "model")
    if dim is None:
        return None
    return dim, sh.lines("model"), sh.mesh.axis_index("model")


def tp_enter(x: torch.Tensor) -> torch.Tensor:
    """*f* over ``model`` (``collectives.enter``); the identity outside a
    sharded step."""
    sh = _STEP.get()
    return x if sh is None else enter(x, sh.mesh, "model")


def tp_leave(x: torch.Tensor) -> torch.Tensor:
    """*g* over ``model`` (``collectives.leave``); the identity outside
    a sharded step.  Half-precision partial sums are added in float32
    and rounded once (a bf16 all-reduce would round at every hop)."""
    sh = _STEP.get()
    if sh is None or sh.lines("model") == 1:
        return x
    if x.dtype in (torch.bfloat16, torch.float16):
        return leave(x.float(), sh.mesh, "model").to(x.dtype)
    return leave(x, sh.mesh, "model")


# -- the sequence-parallel residual stream ----------------------------------


@contextlib.contextmanager
def residual_stream(tokens: int) -> Iterator[bool]:
    """Within the block the residual stream of ``tokens`` tokens (the
    cache-free forward's, the encoder's, the teacher-forced decoder's)
    is held as this rank's ``tokens / model`` of them, where the step
    asks for ``act_sp`` and ``model`` divides ``tokens``; yields whether
    it is.  Elsewhere, and where ``model`` does not divide the tokens,
    the stream stays whole (the step's values are the same: JAX's layout
    departs from the cut there too)."""
    sh = _STEP.get()
    n = 1 if sh is None else sh.lines("model")
    if sh is None or not sh.act_sp or n == 1 or tokens % n:
        yield False
        return
    token = _STEP.set(dataclasses.replace(sh, tokens_cut=True))
    try:
        yield True
    finally:
        _STEP.reset(token)


def _cut_stream() -> Optional[StepShards]:
    sh = _STEP.get()
    return sh if sh is not None and sh.tokens_cut else None


def tp_out(y: torch.Tensor, partial: bool) -> torch.Tensor:
    """A sublayer's output ``y`` (B, S, D) on its way back to the
    residual stream, ``partial`` where it is this rank's partial sum over
    ``model``: summed (:func:`tp_leave`), or on a stream cut along its
    tokens reduce-scattered to this rank's tokens (half precision added
    in float32 and rounded once, as :func:`tp_leave` adds it).  A whole
    ``y`` is itself, or on a cut stream narrowed to this rank's
    tokens."""
    sh = _cut_stream()
    if sh is None:
        return tp_leave(y) if partial else y
    if not partial:
        return split_grad(y, sh.mesh, "model", 1)
    if y.dtype in (torch.bfloat16, torch.float16):
        return scatter_grad(y.float(), sh.mesh, "model", 1).to(y.dtype)
    return scatter_grad(y, sh.mesh, "model", 1)


def stream_gather(x: torch.Tensor) -> torch.Tensor:
    """The whole stream (B, S, D) from this rank's tokens of it, on a
    stream cut along its tokens (``x`` elsewhere).  Its gradient is the
    rank's tokens of the whole one: the sublayers enter the gathered
    value through *f*, which sums the gradient over ``model``."""
    sh = _cut_stream()
    return x if sh is None else gather_keep(x, sh.mesh, "model", 1)


def stream_gain(g: torch.Tensor) -> torch.Tensor:
    """A replicated norm gain as a norm on the rank's tokens uses it:
    entered through *f* (its gradient, a sum over the rank's tokens,
    summed over ``model``) on a cut stream, ``g`` itself elsewhere."""
    return g if _cut_stream() is None else tp_enter(g)


def tp_gather(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The slots' shards of ``x`` along ``dim`` concatenated over
    ``model``, the gradient reduce-scattered back
    (``collectives.gather_grad``)."""
    sh = _STEP.get()
    return gather_grad(x, sh.mesh, "model", dim % x.dim())


def model_cols(w: torch.Tensor, y: torch.Tensor, lo: int, hi: int,
               total: int) -> torch.Tensor:
    """Columns ``[lo, hi)`` of the ``total`` a projection outputs, from
    this rank's ``y = x @ w`` (``w`` column-cut over ``model``, or
    whole): ``y`` itself when its shard is those columns, else the
    shards gathered over ``model`` (the gradient reduce-scattered back)
    and sliced."""
    cut = model_cut(w)
    if cut is not None:
        _, n, j = cut
        if (lo, hi) == (j * total // n, (j + 1) * total // n):
            return y
        y = tp_gather(y)
    return y if (lo, hi) == (0, total) else y[..., lo:hi]


def tp_place(x: torch.Tensor, lo: int, total: int, dim: int = -1
             ) -> torch.Tensor:
    """A value every slot then holds whole, of ``total`` along ``dim``,
    from this rank's block of it, ``[lo, lo + x.shape[dim])``: each
    slot's block set in zeros and the results summed over ``model``
    (each element has one nonzero term, so the sum is exact), the
    gradient this rank's block of the whole one's.  The slots' blocks
    must not overlap and must cover ``[0, total)``; an empty block is
    allowed.  ``x`` itself outside a sharded step or where it is whole
    already."""
    block = model_block(x, lo, total, dim)
    return x if block is x else tp_leave(block)


def model_block(x: torch.Tensor, lo: int, total: int, dim: int = -1
                ) -> torch.Tensor:
    """This rank's term of :func:`tp_place`'s sum: its block ``x`` set
    at ``[lo, lo + x.shape[dim])`` in zeros of ``total`` along ``dim``
    (``x`` itself outside a sharded step or where it is whole
    already)."""
    sh = _STEP.get()
    dim = dim % x.dim()
    if sh is None or sh.lines("model") == 1 or x.shape[dim] == total:
        return x
    hi = lo + x.shape[dim]
    pad = []
    for n in (lo, total - hi):
        shape = list(x.shape)
        shape[dim] = n
        pad.append(x.new_zeros(shape))
    return torch.cat([pad[0], x, pad[1]], dim)


def model_part(t: torch.Tensor, lo: int, hi: int, dim: int = 0
               ) -> torch.Tensor:
    """Elements ``[lo, hi)`` along ``dim`` of the parameter ``t``, which
    a rank's share of a cut layer computes with: its shard where
    ``model`` cuts it (the shard is those elements), else the whole leaf
    entered through f (its gradient summed over ``model``) and then
    sliced.  Call it only where the layer's output is summed over
    ``model`` afterwards."""
    if model_cut(t) is not None:
        return use(t)
    return tp_enter(use(t)).narrow(dim, lo, hi - lo)


def batch_psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the axis the batch rows are cut over (no
    gradient); ``x`` where no axis cuts them."""
    sh = _STEP.get()
    if sh is None or sh.lines(sh.batch_axis) == 1:
        return x
    return psum(x, sh.mesh, sh.batch_axis)


def batch_lines() -> int:
    """The slots the batch rows are cut over (1 outside a step)."""
    sh = _STEP.get()
    return 1 if sh is None else sh.lines(sh.batch_axis)


def gather_seq(cache: torch.Tensor, dim: int) -> torch.Tensor:
    """A contiguous cache leaf whose sequence (``dim``) the step cuts
    over ``cache_seq_axis`` all-gathered whole; elsewhere ``cache``
    itself (as :func:`gather_pool` does for the page pool)."""
    sh = _STEP.get()
    if sh is None or sh.lines(sh.cache_seq_axis) == 1:
        return cache
    return all_gather(cache, sh.mesh, sh.cache_seq_axis, dim)


def keep_seq(cache: torch.Tensor, full: torch.Tensor, dim: int) -> None:
    """Copy this rank's sequence slice of ``full`` (from
    :func:`gather_seq`, written since) back into ``cache``; nothing when
    ``full`` is ``cache``."""
    if full is cache:
        return
    sh = _STEP.get()
    n = cache.shape[dim]
    i = sh.mesh.axis_index(sh.cache_seq_axis)
    cache.copy_(full.narrow(dim, i * n, n))


def gather_shards(tree, mesh, shardings) -> Any:
    """Every rank's shards of ``tree`` put back together: each leaf
    whole on every rank of ``mesh`` (no gradient), under ``shardings``
    (:func:`param_shardings`' dict for a module or for tensors keyed by
    its names, :func:`cache_shardings`' tree otherwise)."""
    def whole(t, spec):
        spec = tuple(spec)
        if len(spec) == t.dim() + 1:
            spec = spec[1:]
        for dim, entry in enumerate(spec):
            if entry is not None:
                t = all_gather(t.contiguous(), mesh, entry, dim)
        return t

    if isinstance(shardings, dict) and all(
            isinstance(v, NamedSharding) for v in shardings.values()):
        from repro_torch.models.convert import named    # keyed by name
        return {name: whole(t.detach(), shardings[name].spec)
                for name, t in named(tree).items()}

    def put(names, t):
        sh = shardings
        for k in names:
            sh = sh[int(k) if isinstance(sh, (list, tuple)) else k]
        return whole(t, sh.spec)
    return _tree_map(put, tree)
