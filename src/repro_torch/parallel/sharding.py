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
from repro_torch.parallel.collectives import all_gather


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
    (``nn.Module.to`` would move the original in place)."""
    params = dict(module.named_parameters())
    cut = {n: (shard(n, p) if shard else p) for n, p in params.items()}
    tensors = list(cut.values()) + list(module.buffers())
    if all(t.device == device for t in tensors) and all(
            cut[n] is params[n] for n in params):
        return module
    memo = {}
    for n, p in params.items():
        memo[id(p)] = nn.Parameter(cut[n].detach().to(device),
                                   requires_grad=p.requires_grad)
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
