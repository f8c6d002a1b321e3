"""Local transport: an in-process deque (the port's copy of
``repro.channels.local``), with the same traced post-event depths.
"""

from __future__ import annotations

from collections import deque
from typing import Any

from repro_torch.channels.base import ChannelBase


class LocalChannel(ChannelBase):
    """Bounded FIFO between engines of one process."""

    __slots__ = ("_q",)

    transport = "local"

    def __init__(self, name, capacity=None, tracer=None, instance="serve"):
        super().__init__(name, capacity, tracer, instance)
        self._q: deque = deque()

    def push(self, item: Any) -> bool:
        if self.capacity is not None and len(self._q) >= self.capacity:
            return False
        self._q.append(item)
        self._trace(len(self._q))
        return True

    def pop(self) -> Any:
        item = self._q.popleft()
        self._trace(len(self._q))
        return item

    def peek(self) -> Any:
        return self._q[0]

    def __len__(self) -> int:
        return len(self._q)
