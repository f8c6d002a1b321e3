"""The Channel protocol: the port's copy of ``repro.channels.base``.

A bounded FIFO joining two engines of the serve loop (paper §3:
access/execute engines joined by capacity-bounded channels).  ``push``
maps to the DAE program's ``Enq``, ``pop`` to ``Deq`` and ``capacity``
to the channel capacity.  Every mutation reports its post-event depth to
``Tracer.on_occupancy(instance, name, depth, t)``, so a serve-loop trace
reads like a DAE program trace.  The local transport (the serve loop's
queue), the simulator's timed FIFO (``channels/sim.py``) and the mesh
transport (``channels/mesh.py``) are ported.
"""

from __future__ import annotations

import abc
from typing import Any, Optional

from repro_torch.core.trace import Tracer


class ChannelBase(abc.ABC):
    """Bounded FIFO protocol: ``push`` refuses beyond ``capacity``
    (backpressure, returning False), ``pop`` takes from the front, and
    every mutation traces the post-event depth under ``instance``.

    ``capacity=None`` means unbounded (the serve admit queue's default).
    """

    __slots__ = ("name", "capacity", "tracer", "instance")

    transport: str = "abstract"

    def __init__(self, name: str, capacity: Optional[int] = None,
                 tracer: Optional[Tracer] = None,
                 instance: str = "serve"):
        self.name = name
        self.capacity = capacity
        self.tracer = tracer
        self.instance = instance

    # -- transport surface ---------------------------------------------------

    @abc.abstractmethod
    def push(self, item: Any) -> bool:
        """Append ``item``; False (and no side effects) when full."""

    @abc.abstractmethod
    def pop(self) -> Any:
        """Remove and return the front item (IndexError when empty)."""

    @abc.abstractmethod
    def peek(self) -> Any:
        """Front item without removing it."""

    @abc.abstractmethod
    def __len__(self) -> int:
        ...

    # -- shared behavior -----------------------------------------------------

    def _trace(self, depth: int, t: float = 0.0) -> None:
        if self.tracer is not None:
            self.tracer.on_occupancy(self.instance, self.name, depth, t)

    @property
    def occupancy(self) -> int:
        return len(self)

    @property
    def full(self) -> bool:
        return self.capacity is not None and len(self) >= self.capacity

    def __bool__(self) -> bool:
        return len(self) > 0
