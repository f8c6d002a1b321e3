"""Channel-occupancy tracing for the serve loop: the part of
``repro.core.trace`` that serving drives.

Every push and pop on a serve-loop channel reports the channel's
post-event depth to :meth:`Tracer.on_occupancy`; the summary keeps the
event count, the depth sum and the peak per channel, so mean and peak
occupancy come out without storing a timeline.  A loop without a tracer
does no per-event work: every hook sits behind one ``is not None``
check.  The request-latency histograms and port timelines, which only
the DAE simulator feeds, come with the simulator's port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

__all__ = ["ChannelStats", "TraceSummary", "Tracer"]


@dataclasses.dataclass
class ChannelStats:
    """Occupancy statistics for one channel."""

    events: int = 0          # push/pop events observed
    occ_sum: int = 0         # sum of post-event FIFO depths
    occ_max: int = 0         # peak FIFO depth

    @property
    def occ_mean(self) -> float:
        return self.occ_sum / self.events if self.events else 0.0


@dataclasses.dataclass
class TraceSummary:
    """Per-channel statistics, keyed ``"instance/name"``."""

    channels: Dict[str, ChannelStats]

    def channel_occupancy(self, merge_instances: bool = False
                          ) -> Dict[str, Tuple[float, int]]:
        """``{channel: (mean_occupancy, max_occupancy)}``; with
        ``merge_instances`` the instance qualifier is stripped and stats
        of the same base channel name are pooled."""
        out: Dict[str, List[ChannelStats]] = {}
        for name, cs in self.channels.items():
            base = name.rsplit("/", 1)[-1] if merge_instances else name
            out.setdefault(base, []).append(cs)
        return {
            name: (
                sum(c.occ_sum for c in group)
                / max(1, sum(c.events for c in group)),
                max(c.occ_max for c in group),
            )
            for name, group in out.items()
        }


class Tracer:
    """Streaming collector the channels call into."""

    def __init__(self) -> None:
        self._channels: Dict[str, ChannelStats] = {}

    def on_occupancy(self, instance: str, channel: str,
                     depth: int, t: float = 0.0) -> None:
        key = f"{instance}/{channel}" if instance else channel
        cs = self._channels.get(key)
        if cs is None:
            cs = self._channels[key] = ChannelStats()
        cs.events += 1
        cs.occ_sum += depth
        if depth > cs.occ_max:
            cs.occ_max = depth

    def summary(self) -> TraceSummary:
        return TraceSummary(channels=dict(self._channels))
