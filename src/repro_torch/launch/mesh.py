"""Device meshes: the port's counterpart of ``repro.launch.mesh``.

Two kinds of mesh, both a numpy array of slots with named axes:

* :class:`Mesh`: its slots are *logical* devices, and several slots may
  name one physical device, as JAX's forced host devices put 8 logical
  devices on one CPU.  The CPU tests pass
  ``devices=[torch.device("cpu")] * 8``; on one card ``[cuda:0, cuda:0]``
  gives the disaggregated serving placement, ``[cuda:0, cuda:1]`` puts
  its two engines on two cards of one process.
* :class:`RankMesh`: its slots are the *ranks* of the initialised
  default ``torch.distributed`` process group, one process each (one
  per card under ``nccl``, one per logical CPU device under ``gloo``).
  It builds one sub-group per line of every axis and of every plane of
  several axes (a tuple ``axis_name``: the batch's ``("pod", "data")``),
  the counterpart of a ``jax.lax`` collective's ``axis_name``;
  ``parallel/collectives.py``
  runs the collectives over them.  Building one is collective: every
  rank of the group builds every rank mesh, in the same order, as
  ``torch.distributed.new_group`` requires.  Without an initialised
  group it raises; it never falls back to a mesh of logical devices.

``devices`` defaults to every visible CUDA device; ``ranks=True`` takes
the group's ranks instead.  The constructors validate as JAX's do: too
few devices raises a ``RuntimeError`` that names the deficit and the
fix.
"""

from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _physical(device) -> torch.device:
    """The physical device a slot names: ``cuda`` is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Logical devices laid out on named axes (JAX's ``Mesh``):
    ``devices`` an object array of ``torch.device``, ``axis_names``, and
    ``shape`` a dict of axis name to size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devs = np.asarray(devices, dtype=object)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if devs.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {devs.shape} do not match "
                             f"axes {self.axis_names}")
        self.devices = devs

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def slot_device(self, axis: str, i: int) -> torch.device:
        """The device of slot ``i`` along ``axis`` (index 0 on the other
        axes, over which a spec of ``axis`` alone replicates)."""
        idx = [0] * self.devices.ndim
        idx[self.axis_names.index(axis)] = i
        return self.devices[tuple(idx)]

    def physical_devices(self) -> List[torch.device]:
        """The distinct physical devices the slots name, in slot order."""
        out: List[torch.device] = []
        for d in self.devices.flat:
            p = _physical(d)
            if p not in out:
                out.append(p)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.physical_devices()})"


def world_size() -> int:
    """The size of the initialised default process group; raises
    without one (a rank mesh never falls back to logical devices)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a rank mesh needs an initialised torch.distributed process "
            "group: call torch.distributed.init_process_group first, or "
            "run the ranks through repro_torch.launch.spawn")
    return dist.get_world_size()


def rank_device(rank: Optional[int] = None) -> torch.device:
    """The device of ``rank`` (default: this process): under ``nccl``
    card ``rank`` modulo the visible cards (one process per card, as
    :func:`~repro_torch.launch.spawn.spawn` places them; this process's
    own is its current card), under any other backend the CPU."""
    if dist.get_backend() != "nccl":
        return torch.device("cpu")
    if rank is None or rank == dist.get_rank():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda", rank % torch.cuda.device_count())


# the sub-groups built so far, per default group: a rank mesh built
# again (or another mesh over the same line of ranks) reuses them
_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _group(line: Tuple[int, ...]):
    """The process group of the ranks ``line``; every rank of the
    default group calls this for every line, in the same order."""
    world = dist.group.WORLD
    if len(line) == dist.get_world_size():
        return world
    groups = _GROUPS.setdefault(world, {})
    key = tuple(sorted(line))
    if key not in groups:
        groups[key] = dist.new_group(list(key))
    return groups[key]


class RankMesh(Mesh):
    """Ranks of the default process group laid out on named axes.

    ``ranks`` is an int array of global ranks, one per slot.  Each slot's
    device is :func:`rank_device` of its rank; ``device`` is this
    process's.  ``coords`` is this rank's slot (``None`` when the mesh
    does not hold it: ``member`` is then False and it takes no part in
    the mesh's collectives).  Each axis has one sub-group per line of
    slots along it (:meth:`axis_group`), and so has each tuple of two or
    more axes in the mesh's order, its lines the planes they span, slots
    in row-major order; axis ``None`` names the whole mesh, its slots in
    row-major order, as does the tuple of all its axes.  Every sub-group
    is built here: ``torch.distributed.new_group`` is collective, so none
    can be made later by some ranks alone."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        world = world_size()
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.size and (ranks.min() < 0 or ranks.max() >= world
                           or len(np.unique(ranks)) != ranks.size):
            raise ValueError(f"ranks {ranks.tolist()} are not distinct "
                             f"ranks of a group of {world}")
        devs = np.empty(ranks.shape, dtype=object)
        for idx, r in np.ndenumerate(ranks):
            devs[idx] = rank_device(int(r))
        super().__init__(devs, axis_names)
        self.ranks = ranks
        self.rank = dist.get_rank()
        self.device = rank_device()
        where = np.argwhere(ranks == self.rank)
        self.coords: Optional[Tuple[int, ...]] = \
            tuple(int(c) for c in where[0]) if len(where) else None
        self._lines: Dict[object, Tuple[object, Tuple[int, ...]]] = {}
        dims = range(len(self.axis_names))
        for k in range(1, max(2, len(self.axis_names))):
            for sub in itertools.combinations(dims, k):
                size = int(np.prod([ranks.shape[i] for i in sub]))
                lines = np.moveaxis(ranks, sub, range(-k, 0)).reshape(
                    -1, size)
                key = self._key(tuple(self.axis_names[i] for i in sub))
                for line in lines:
                    line = tuple(int(r) for r in line)
                    group = _group(line)
                    if self.rank in line:
                        self._lines[key] = (group, line)
        flat = tuple(int(r) for r in ranks.flat)
        group = _group(flat)
        if self.rank in flat:
            self._lines[None] = (group, flat)

    @property
    def member(self) -> bool:
        return self.coords is not None

    def _key(self, axis):
        """``axis`` as :attr:`_lines` keys it: a name, a tuple of several
        names in the mesh's order, or ``None`` for all of them."""
        if axis is None or isinstance(axis, str):
            return axis
        axis = tuple(axis)
        if len(axis) == 1:
            return axis[0]
        if axis == self.axis_names:
            return None
        if sorted(axis, key=self.axis_names.index) != list(axis):
            raise ValueError(f"axes {axis} are not in the order of "
                             f"{self.axis_names}")
        return axis

    def axis_group(self, axis):
        """(process group, global ranks in slot order) of this rank's
        line along ``axis`` (a name, a tuple of names, or ``None``)."""
        if not self.member:
            raise ValueError(f"rank {self.rank} is not on {self}")
        return self._lines[self._key(axis)]

    def axis_index(self, axis) -> int:
        """This rank's slot along ``axis`` (``jax.lax.axis_index``)."""
        return self.axis_group(axis)[1].index(self.rank)

    def physical_devices(self) -> List[torch.device]:
        return [self.device] if self.member else []

    def __repr__(self) -> str:
        return f"RankMesh({self.shape}, ranks {self.ranks.tolist()})"


def _devices(devices) -> List[torch.device]:
    if devices is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def _take(devices, n: int, what: str, ranks: bool = False) -> np.ndarray:
    """The first ``n`` slots: of ``devices``, or the default group's
    ranks when ``ranks``."""
    if ranks:
        if devices is not None:
            raise ValueError("pass devices= or ranks=True, not both")
        slots = list(range(world_size()))
        fix = f"start at least {n} ranks"
    else:
        slots = _devices(devices)
        fix = (f"pass devices= with at least {n} (slots may repeat one "
               f"physical device, e.g. [torch.device('cpu')] * {n})")
    if len(slots) < n:
        raise RuntimeError(
            f"need {n} devices for {what}, have {len(slots)}; {fix}")
    out = np.empty(n, dtype=np.int64 if ranks else object)
    out[:] = slots[:n]
    return out


def _mesh(slots: np.ndarray, axes, ranks: bool) -> Mesh:
    return RankMesh(slots, axes) if ranks else Mesh(slots, axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    return Mesh(_take(devices, n, f"mesh {shape}").reshape(shape), axes)


def make_debug_mesh(shape=(2, 4), axes=("data", "model"), devices=None,
                    *, ranks: bool = False) -> Mesh:
    """Small mesh for unit tests (e.g. 8 logical CPU devices, or 8
    ranks with ``ranks=True``: the first ``prod(shape)`` of the default
    group, so with more ranks the rest are not members)."""
    n = int(np.prod(shape))
    return _mesh(_take(devices, n, f"mesh {tuple(shape)}", ranks)
                 .reshape(shape), axes, ranks)


@dataclasses.dataclass(frozen=True)
class ServeMeshes:
    """Device placement of the sharded serving pipeline.

    ``prefill``/``decode`` are the Access and Execute engines' meshes;
    ``union`` covers both and carries the cross-engine
    :class:`~repro_torch.channels.mesh.MeshChannel` rings.  When
    ``disaggregated`` the two engine meshes are disjoint halves (the
    union gains a leading ``role`` axis of size 2: row 0 prefill, row 1
    decode) joined only by channels; otherwise all three are one mesh
    and the channels ride its ``data`` axis.
    """

    union: Mesh
    prefill: Mesh
    decode: Mesh
    disaggregated: bool
    axis: str = "data"
    role_axis: str = "role"


def make_serve_meshes(n: Optional[int] = None, *,
                      disaggregate: Optional[bool] = None,
                      devices=None, ranks: bool = False) -> ServeMeshes:
    """Carve the first ``n`` of ``devices`` (or, with ``ranks``, of the
    default group's ranks, as :class:`RankMesh` meshes) into serving
    meshes.

    ``disaggregate`` defaults to splitting whenever an even n >= 2 is
    available; ``n`` defaults to every device (or rank) given.  n=1 is
    always one mesh shared by both engines (the bit-parity
    configuration).  Disaggregated, the first half of the slots runs
    prefill and the second half decode.
    """
    if n is None:
        n = max(1, world_size() if ranks else len(_devices(devices)))
    if n < 1:
        raise ValueError(f"need n >= 1 serving devices, got {n}")
    slots = _take(devices, n, "serving meshes", ranks)
    if disaggregate is None:
        disaggregate = n >= 2 and n % 2 == 0
    if disaggregate and (n < 2 or n % 2):
        raise ValueError(
            f"disaggregated serving splits devices in half, got n={n}")
    if not disaggregate:
        mesh = _mesh(slots, ("data",), ranks)
        return ServeMeshes(mesh, mesh, mesh, False)
    half = n // 2
    union = _mesh(slots.reshape(2, half), ("role", "data"), ranks)
    prefill = _mesh(slots[:half], ("data",), ranks)
    decode = _mesh(slots[half:], ("data",), ranks)
    return ServeMeshes(union, prefill, decode, True)
