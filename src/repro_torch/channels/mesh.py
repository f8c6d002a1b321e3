"""Mesh transport: a ring of device rows over a named mesh axis (the
port's counterpart of ``repro.channels.mesh``).

The decoupled serving pipeline's cross-engine edge.  Each channel owns
one ``(capacity, width)`` int32 ring row per slot along ``axis``, on
that slot's device.  ``push`` builds the payload on the ``src`` slot's
device and copies it into the ``dst`` row at the tail: a real
cross-device copy when the two slots name different devices, an
on-device copy otherwise (JAX moves it with ``ppermute``).  ``pop`` and
``peek`` read the ``dst`` row's entry back to the host.  With span 1 the
transport is a single-device queue that behaves exactly as
:class:`~repro_torch.channels.local.LocalChannel` does.

On a :class:`~repro_torch.launch.mesh.RankMesh` each rank holds its own
slot's row.  ``push`` sends the payload from the ``src`` slot's rank to
the ``dst`` slot's (``ppermute`` along the axis); ``pop`` and ``peek``
broadcast the ``dst`` row's entry along the axis, so every rank returns
the value that travelled.  Every rank of the axis line calls every
method in the same order, as the serving loop's identical host state
makes them.

Division of labor, as in the reference: payload *values* travel the
device rows; head/tail cursors, occupancy (backpressure) and each
entry's Python shape (bare int vs tuple arity) stay on the host.
Tracing follows the shared vocabulary (post-event depth, ``base.py``).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.channels.base import ChannelBase
from repro_torch.launch.mesh import RankMesh
from repro_torch.parallel.collectives import broadcast, ppermute

_I32 = 2 ** 31


class MeshChannel(ChannelBase):
    """Bounded FIFO whose entries travel ``src -> dst`` along a mesh
    axis.

    Entries are ints or (short) tuples of ints: the pipeline's control
    messages (slot ids, first tokens).  ``width`` bounds the tuple
    arity; ``capacity`` is the ring depth of every row.
    """

    transport = "mesh"

    def __init__(self, name: str, capacity: int, mesh, axis: str = "data",
                 *, src: int = 0, dst: Optional[int] = None, width: int = 2,
                 tracer=None, instance: str = "serve"):
        if capacity is None or capacity < 1:
            raise ValueError("MeshChannel needs a finite capacity >= 1 "
                             "(it is a fixed-size device ring buffer)")
        if axis not in mesh.axis_names:
            raise ValueError(
                f"axis {axis!r} not in mesh axes {mesh.axis_names}")
        super().__init__(name, capacity, tracer, instance)
        self.mesh = mesh
        self.axis = axis
        self.width = width
        self.span = int(mesh.shape[axis])
        self.src = int(src) % self.span
        self.dst = int(self.span - 1 if dst is None else dst) % self.span
        self._ranked = isinstance(mesh, RankMesh)
        if self._ranked:
            if not mesh.member:
                raise ValueError(f"rank {mesh.rank} is not on {mesh}")
            self._me = mesh.axis_index(axis)
            self.rows = [None] * self.span
            self.rows[self._me] = torch.zeros(
                (capacity, width), dtype=torch.int32, device=mesh.device)
        else:
            self.rows = [torch.zeros((capacity, width), dtype=torch.int32,
                                     device=mesh.slot_device(axis, i))
                         for i in range(self.span)]
        self._head = 0
        self._tail = 0
        self._count = 0
        self._meta: deque = deque()      # (kind, arity) per in-flight entry

    # -- wire format ---------------------------------------------------------

    def _encode(self, item: Any) -> Tuple[str, Tuple[int, ...]]:
        if isinstance(item, (int, np.integer)):
            vals: Tuple[int, ...] = (int(item),)
            kind = "i"
        elif isinstance(item, (tuple, list)):
            vals = tuple(int(v) for v in item)
            kind = "t"
        else:
            raise TypeError(
                f"mesh transport carries int / tuple-of-int control "
                f"messages, got {type(item).__name__}")
        if len(vals) > self.width:
            raise ValueError(f"entry arity {len(vals)} exceeds channel "
                             f"width {self.width}")
        for v in vals:
            if not -_I32 <= v < _I32:
                raise ValueError(f"entry value {v} does not fit int32")
        return kind, vals

    def _read(self, slot: int, kind: str, arity: int) -> Any:
        if self._ranked:
            entry = self.rows[self._me][slot].clone() \
                if self._me == self.dst else torch.zeros(
                    self.width, dtype=torch.int32, device=self.mesh.device)
            row = broadcast(entry, self.mesh, self.axis, self.dst).tolist()
        else:
            row = self.rows[self.dst][slot].tolist()
        if kind == "i":
            return int(row[0])
        return tuple(int(v) for v in row[:arity])

    # -- protocol surface ----------------------------------------------------

    def push(self, item: Any) -> bool:
        if self._count >= self.capacity:
            return False
        kind, vals = self._encode(item)
        pay = np.zeros(self.width, np.int32)
        pay[:len(vals)] = vals
        if self._ranked:
            moved = ppermute(torch.as_tensor(pay, device=self.mesh.device),
                             self.mesh, self.axis, [(self.src, self.dst)])
            if self._me == self.dst:
                self.rows[self.dst][self._tail].copy_(moved)
        else:
            src = torch.as_tensor(pay, device=self.rows[self.src].device)
            self.rows[self.dst][self._tail].copy_(src)
        self._tail = (self._tail + 1) % self.capacity
        self._meta.append((kind, len(vals)))
        self._count += 1
        self._trace(self._count)
        return True

    def pop(self) -> Any:
        if not self._count:
            raise IndexError(f"pop from empty mesh channel {self.name!r}")
        kind, arity = self._meta.popleft()
        item = self._read(self._head, kind, arity)
        self._head = (self._head + 1) % self.capacity
        self._count -= 1
        self._trace(self._count)
        return item

    def peek(self) -> Any:
        if not self._count:
            raise IndexError(f"peek at empty mesh channel {self.name!r}")
        kind, arity = self._meta[0]
        return self._read(self._head, kind, arity)

    def __len__(self) -> int:
        return self._count
