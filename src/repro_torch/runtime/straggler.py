"""Straggler detection: per-step wall-time EWMA + outlier flagging (the
counterpart of ``repro.runtime.straggler``).

On a real pod this feeds the controller that triggers slice re-formation
(drop the slow host, re-mesh, restore from the last checkpoint — the
elastic path exercised in tests via CheckpointManager).  Here it logs and
counts, and is unit-tested against synthetic timings.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    ewma: float
    ratio: float


class StragglerMonitor:
    def __init__(self, threshold: float = 2.5, alpha: float = 0.1,
                 warmup_steps: int = 5,
                 on_straggler: Optional[Callable[[StragglerEvent], None]]
                 = None):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup_steps = warmup_steps
        self.on_straggler = on_straggler
        self.ewma: Optional[float] = None
        self.events: List[StragglerEvent] = []
        self._n = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int, duration: Optional[float] = None) -> bool:
        """Record a step duration; returns True if flagged as straggler."""
        if duration is None:
            if self._t0 is None:
                raise RuntimeError("stop() without start()")
            duration = time.perf_counter() - self._t0
            self._t0 = None
        self._n += 1
        if self.ewma is None:
            self.ewma = duration
            return False
        flagged = (self._n > self.warmup_steps and
                   duration > self.threshold * self.ewma)
        if flagged:
            ev = StragglerEvent(step, duration, self.ewma,
                                duration / self.ewma)
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
            # do not fold outliers into the EWMA (keeps the baseline clean)
            return True
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * duration
        return False
