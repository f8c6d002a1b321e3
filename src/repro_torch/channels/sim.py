"""Sim transport: the DAE simulator's timed channel FIFO.

The port's copy of ``repro.channels.sim``, unchanged but
for imports: host code, held bit for bit to the reference by
``tests/test_torch_dae_model.py``.

Entries are ``(ready_time, value)`` pairs: a ``Req`` lands when the
memory system delivers it, an ``Enq`` becomes visible one cycle after
it is issued, and the engines' readiness oracles peek ``front_ready``
before committing a ``Resp``/``Deq``.  Both scheduler engines
(polling and event) mutate channel state exclusively through
:meth:`push_timed`/:meth:`pop_timed`, which also emit the shared
occupancy vocabulary (post-event depth — see ``base.py``), so the
simulator's golden traces and the serve loop's traces are produced by
the same code path.

The conservation counters (``reqs``/``resps``/``enqs``/``deqs``) back
the §5.1 request/response conservation check in
``DaeProgram``/``validate``; ``push_key``/``pop_key`` are the event
engine's wake keys, stored here so one dict lookup fetches FIFO and
keys together (the scheduler hot path).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Optional, Tuple

from repro_torch.channels.base import ChannelBase


class SimChannel(ChannelBase):
    """Timed FIFO with simulator semantics plus the shared protocol.

    The protocol surface (``push``/``pop``/``peek``) treats the channel
    as an immediate-delivery queue (ready at push time) so transport-
    generic code and tests can drive it; the engines use the timed
    surface directly.
    """

    __slots__ = ("fifo", "reqs", "resps", "enqs", "deqs",
                 "push_key", "pop_key")

    transport = "sim"

    def __init__(self, name: str = "", capacity: Optional[int] = None,
                 tracer=None, instance: str = "sim"):
        super().__init__(name, capacity, tracer, instance)
        self.fifo: "deque[Tuple[float, Any]]" = deque()  # (ready_time, value)
        self.reqs = 0
        self.resps = 0
        self.enqs = 0
        self.deqs = 0
        # event-engine wake keys, filled lazily by the scheduler
        self.push_key: Optional[Tuple] = None
        self.pop_key: Optional[Tuple] = None

    # -- timed engine surface ------------------------------------------------

    def push_timed(self, ready: float, value: Any, kind: str,
                   trace=None, instance: str = "", name: str = "",
                   t: float = 0.0) -> None:
        """Append an entry landing at ``ready``; ``kind`` is ``"req"``
        (memory response in flight) or ``"enq"`` (producer enqueue).
        Capacity is enforced by the engines' readiness oracles *before*
        the effect executes, not here."""
        self.fifo.append((ready, value))
        if kind == "req":
            self.reqs += 1
        else:
            self.enqs += 1
        if trace is not None:
            trace.on_occupancy(instance, name or self.name,
                               len(self.fifo), t)

    def pop_timed(self, kind: str, trace=None, instance: str = "",
                  name: str = "", t: float = 0.0) -> Any:
        """Take the front entry's value; ``kind`` is ``"resp"`` or
        ``"deq"``.  Readiness (front entry landed, FIFO non-empty) is
        the engines' responsibility."""
        _, value = self.fifo.popleft()
        if kind == "resp":
            self.resps += 1
        else:
            self.deqs += 1
        if trace is not None:
            trace.on_occupancy(instance, name or self.name,
                               len(self.fifo), t)
        return value

    @property
    def front_ready(self) -> float:
        """Ready time of the front entry (IndexError when empty)."""
        return self.fifo[0][0]

    # -- shared protocol surface ---------------------------------------------

    def push(self, item: Any) -> bool:
        if self.capacity is not None and len(self.fifo) >= self.capacity:
            return False
        self.push_timed(0.0, item, "enq", self.tracer, self.instance,
                        self.name)
        return True

    def pop(self) -> Any:
        return self.pop_timed("deq", self.tracer, self.instance, self.name)

    def peek(self) -> Any:
        return self.fifo[0][1]

    def __len__(self) -> int:
        return len(self.fifo)
