"""Streaming trace subsystem for the DAE engine.

The port's copy of ``repro.core.trace``, unchanged but
for imports: host code, held bit for bit to the reference by
``tests/test_torch_dae_model.py``.

Dávila-Guzmán et al.'s analytical model and the dataflow template of
Cheng & Wawrzynek (PAPERS.md) both predict decoupled performance from
two quantities the simulator previously discarded: per-channel buffer
occupancy and shared-port contention.  This module captures exactly
those, as structured records that survive a JSON round trip:

  * **per-channel occupancy** — every enqueue/dequeue on a channel FIFO
    records the post-event depth; the summary keeps event count, sum and
    max, so mean/max occupancy (the §5.4 buffer-sizing signal) come out
    without storing the full timeline;
  * **request-latency histograms** — per channel, the issue-to-land
    latency of each ``Req`` bucketed into powers of two (a coalesced or
    cached MOMS hit lands in a low bucket, a row miss behind a full
    outstanding-request budget in a high one);
  * **port-utilization timelines** — per memory port, issue events
    (reads and writes) counted into fixed-width time bins; utilization
    is issues per bin over the bin width, 1.0 meaning the port's
    one-request-per-cycle slot never idled.

Overhead discipline: the engine holds ``tracer=None`` by default and
guards every hook behind a single ``is not None`` check, so a run with
tracing disabled does no per-event work at all.  With tracing enabled
each hook is O(1) dict arithmetic (no allocation proportional to the
run length unless the run itself is long).

Channel and port keys are instance-qualified as ``"tenant/name"`` when
the engine runs more than one program instance (the empty instance name
of a plain :func:`repro_torch.core.simulator.simulate` call keeps the bare
name), so multi-tenant traces separate per tenant while shared ports
aggregate all tenants' traffic under the one physical port name.

Traces are *scheduler-invariant*: the event-driven engine and the
legacy polling oracle drive these hooks with identical event streams
(same order, same timestamps), so a :class:`TraceSummary` is comparable
across engines byte-for-byte — ``tests/test_parity.py`` pins that, and
``tests/golden/*.json`` pins one summary per workload against
accidental timing-model drift (refresh via ``pytest --update-golden``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

__all__ = ["ChannelStats", "TraceSummary", "Tracer", "pow2_bucket"]


def pow2_bucket(latency: float) -> int:
    """Smallest power of two >= ``latency`` (floor 1): histogram bucket."""
    n = max(1, int(-(-latency // 1)))
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class ChannelStats:
    """Occupancy + request-latency statistics for one channel."""

    events: int = 0          # enq/deq/req/resp events observed
    occ_sum: int = 0         # sum of post-event FIFO depths
    occ_max: int = 0         # peak FIFO depth
    latency_hist: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def occ_mean(self) -> float:
        return self.occ_sum / self.events if self.events else 0.0

    @property
    def requests(self) -> int:
        return sum(self.latency_hist.values())

    def to_json(self) -> Dict:
        return {
            "events": self.events,
            "occ_sum": self.occ_sum,
            "occ_max": self.occ_max,
            "latency_hist": {str(k): v for k, v in
                             sorted(self.latency_hist.items())},
        }

    @classmethod
    def from_json(cls, d: Dict) -> "ChannelStats":
        return cls(events=int(d["events"]), occ_sum=int(d["occ_sum"]),
                   occ_max=int(d["occ_max"]),
                   latency_hist={int(k): int(v)
                                 for k, v in d.get("latency_hist", {}).items()})


@dataclasses.dataclass
class TraceSummary:
    """Everything a trace run collected, JSON-round-trippable.

    ``channels`` maps instance-qualified channel names to
    :class:`ChannelStats`; ``ports`` maps port names to
    ``{bin_index: issue_count}`` timelines with ``bin_cycles``-wide bins.
    """

    bin_cycles: int
    channels: Dict[str, ChannelStats]
    ports: Dict[str, Dict[int, int]]

    def utilization(self, port: str) -> List[Tuple[int, float]]:
        """``(bin_start_cycle, fraction_of_issue_slots_used)`` per bin.

        Only bins that saw at least one issue appear (the store is
        sparse); a whole-run mean must therefore be computed as
        ``port_issues(port) / elapsed_cycles``, not by averaging these
        fractions — averaging skips idle bins and overstates load.
        """
        bins = self.ports.get(port, {})
        return [(b * self.bin_cycles, min(1.0, c / self.bin_cycles))
                for b, c in sorted(bins.items())]

    def port_issues(self, port: str) -> int:
        """Total issue events (reads + writes) recorded on ``port``."""
        return sum(self.ports.get(port, {}).values())

    def channel_occupancy(self, merge_instances: bool = False
                          ) -> Dict[str, Tuple[float, int]]:
        """``{channel: (mean_occupancy, max_occupancy)}``.

        With ``merge_instances`` the per-tenant qualifier is stripped and
        stats for the same base channel name are pooled — the view the
        ``benchmarks.scale`` sweep reports.
        """
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

    def to_json(self) -> Dict:
        return {
            "bin_cycles": self.bin_cycles,
            "channels": {k: v.to_json()
                         for k, v in sorted(self.channels.items())},
            "ports": {p: {str(b): c for b, c in sorted(bins.items())}
                      for p, bins in sorted(self.ports.items())},
        }

    @classmethod
    def from_json(cls, d: Dict) -> "TraceSummary":
        return cls(
            bin_cycles=int(d["bin_cycles"]),
            channels={k: ChannelStats.from_json(v)
                      for k, v in d.get("channels", {}).items()},
            ports={p: {int(b): int(c) for b, c in bins.items()}
                   for p, bins in d.get("ports", {}).items()},
        )


class Tracer:
    """Streaming collector the engine calls into; cheap enough to leave
    on for multi-million-cycle runs, absent entirely when disabled."""

    def __init__(self, bin_cycles: int = 64):
        if bin_cycles < 1:
            raise ValueError("bin_cycles must be >= 1")
        self.bin_cycles = bin_cycles
        self._channels: Dict[str, ChannelStats] = {}
        self._ports: Dict[str, Dict[int, int]] = {}

    # -- hooks (called from the engine's execute path) ----------------------

    def _chan(self, instance: str, channel: str) -> ChannelStats:
        key = f"{instance}/{channel}" if instance else channel
        cs = self._channels.get(key)
        if cs is None:
            cs = self._channels[key] = ChannelStats()
        return cs

    def _port_issue(self, port: str, t: float) -> None:
        bins = self._ports.get(port)
        if bins is None:
            bins = self._ports[port] = {}
        b = int(t // self.bin_cycles)
        bins[b] = bins.get(b, 0) + 1

    def on_request(self, instance: str, channel: str, port: str,
                   t_issue: float, t_done: float) -> None:
        cs = self._chan(instance, channel)
        bucket = pow2_bucket(t_done - t_issue)
        cs.latency_hist[bucket] = cs.latency_hist.get(bucket, 0) + 1
        self._port_issue(port, t_issue)

    def on_occupancy(self, instance: str, channel: str,
                     depth: int, t: float = 0.0) -> None:
        # ``t`` is the scheduler time of the enq/deq/req/resp event that
        # changed the depth; the summary aggregates are time-free, but
        # subclasses (repro_torch.core.waveform.WaveformTracer) keep the full
        # (t, depth) timeline for per-cycle checks and VCD export.
        cs = self._chan(instance, channel)
        cs.events += 1
        cs.occ_sum += depth
        if depth > cs.occ_max:
            cs.occ_max = depth

    def on_store(self, instance: str, port: str, t_issue: float) -> None:
        self._port_issue(port, t_issue)

    # -- results ------------------------------------------------------------

    def summary(self) -> TraceSummary:
        return TraceSummary(bin_cycles=self.bin_cycles,
                            channels=dict(self._channels),
                            ports={p: dict(b)
                                   for p, b in self._ports.items()})
