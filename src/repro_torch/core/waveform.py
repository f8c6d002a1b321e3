"""Full-timeline tracing + VCD export for the DAE engine.

The port's copy of ``repro.core.waveform``, unchanged but
for imports: host code, held bit for bit to the reference by
``tests/test_torch_dae_model.py``.

:class:`repro_torch.core.trace.Tracer` keeps O(1)-per-event *aggregates*
(occupancy means, latency histograms, binned port utilization) — cheap
enough to leave on for multi-million-cycle runs, but a regression that
shifts *when* a channel fills is invisible in them until it moves a
mean.  This module keeps the whole timeline instead:

  * **channel-occupancy waveforms** — every enqueue/dequeue records
    ``(cycle, depth)``, so the exact FIFO depth at any named cycle is
    recoverable (the per-cycle ``check`` primitive of ``tests/dsl.py``);
  * **port-issue waveforms** — every read/write issue records its issue
    cycle, exposed both as a cumulative counter and as per-cycle counts;
  * **VCD export** — the timelines serialize to a Value Change Dump
    (IEEE 1364 §18) with one integer variable per channel/port, viewable
    in GTKWave/Surfer next to an RTL trace, which is how a scheduler
    regression becomes debuggable as a waveform instead of a diff.

The tracer is a strict superset of :class:`Tracer`: the summary
aggregates stay available (and stay byte-identical to a plain tracer's,
pinned by ``tests/test_dsl.py``), so a waveform run can still be
compared against the ``tests/golden/`` fixtures.

Cost discipline: one list append per event — O(run length) memory, which
is why this is a separate opt-in class and not the default tracer.
"""

from __future__ import annotations

import dataclasses
from bisect import bisect_right
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.trace import Tracer

__all__ = ["WaveformTracer", "vcd_identifier"]


def vcd_identifier(index: int) -> str:
    """Compact VCD id code for variable ``index`` (printable ASCII
    ``!``..``~``, little-endian multi-character beyond 94 variables)."""
    chars = []
    index += 1
    while index > 0:
        index -= 1
        chars.append(chr(33 + index % 94))
        index //= 94
    return "".join(chars)


def _sanitize(name: str) -> str:
    """A VCD reference name: no whitespace; ``/`` becomes the hierarchy
    separator ``.`` so multi-tenant signals group per instance."""
    out = name.replace("/", ".")
    return "".join(c if 33 <= ord(c) <= 126 else "_" for c in out)


@dataclasses.dataclass
class _Signal:
    """One recorded timeline: strictly ordered by (cycle, sequence)."""

    times: List[int] = dataclasses.field(default_factory=list)
    values: List[int] = dataclasses.field(default_factory=list)
    _sorted: bool = True

    def record(self, t: float, value: int) -> None:
        ti = int(round(t))
        if self.times and ti < self.times[-1]:
            # scheduler passes execute procs in local-time order, but
            # times can step backwards across instances within a pass
            self._sorted = False
        self.times.append(ti)
        self.values.append(value)

    def _ensure_sorted(self) -> None:
        if not self._sorted:
            pairs = sorted(zip(self.times, range(len(self.times))))
            self.times = [t for t, _ in pairs]
            self.values = [self.values[i] for _, i in pairs]
            self._sorted = True

    def value_at(self, cycle: int, default: int = 0) -> int:
        """Last recorded value at or before ``cycle`` (``default`` when
        nothing has happened yet)."""
        self._ensure_sorted()
        i = bisect_right(self.times, cycle)
        return self.values[i - 1] if i else default

    def changes(self) -> List[Tuple[int, int]]:
        """Deduplicated ``(cycle, value)`` change list: one entry per
        cycle (the last event of that cycle wins), leading no-op changes
        kept so the waveform starts where the run did."""
        self._ensure_sorted()
        out: List[Tuple[int, int]] = []
        for t, v in zip(self.times, self.values):
            if out and out[-1][0] == t:
                out[-1] = (t, v)
            else:
                out.append((t, v))
        return out


class WaveformTracer(Tracer):
    """Streaming collector keeping full per-cycle timelines.

    Drop-in wherever a :class:`Tracer` goes (``run_workload(...,
    tracer=WaveformTracer())``, ``SharedMemoryEngine(..., tracer=...)``);
    the engine hooks are inherited, so summary aggregates remain
    available via :meth:`summary`.
    """

    def __init__(self, bin_cycles: int = 64):
        super().__init__(bin_cycles)
        self._occ: Dict[str, _Signal] = {}
        self._issues: Dict[str, _Signal] = {}   # cumulative issue count
        self._issue_count: Dict[str, int] = {}

    # -- hooks ---------------------------------------------------------------

    def on_occupancy(self, instance: str, channel: str,
                     depth: int, t: float = 0.0) -> None:
        super().on_occupancy(instance, channel, depth, t)
        key = f"{instance}/{channel}" if instance else channel
        sig = self._occ.get(key)
        if sig is None:
            sig = self._occ[key] = _Signal()
        sig.record(t, depth)

    def _port_issue(self, port: str, t: float) -> None:
        # every read (on_request) and write (on_store) funnels through
        # here in the base class, so one override captures both
        super()._port_issue(port, t)
        sig = self._issues.get(port)
        if sig is None:
            sig = self._issues[port] = _Signal()
        n = self._issue_count.get(port, 0) + 1
        self._issue_count[port] = n
        sig.record(t, n)

    # -- per-cycle queries (the DSL's check primitives) ----------------------

    def channels(self) -> Tuple[str, ...]:
        return tuple(sorted(self._occ))

    def ports(self) -> Tuple[str, ...]:
        return tuple(sorted(self._issues))

    def occupancy_at(self, channel: str, cycle: int) -> int:
        """FIFO depth of ``channel`` at ``cycle`` (0 before any event).

        Raises :class:`KeyError` for a channel the run never touched —
        a typo'd check must fail loudly, not read as permanently empty.
        """
        return self._occ[channel].value_at(cycle, 0)

    def peak_occupancy(self, channel: str) -> int:
        sig = self._occ[channel]
        return max(sig.values) if sig.values else 0

    def issues_until(self, port: str, cycle: int) -> int:
        """Read+write issues on ``port`` at or before ``cycle``."""
        sig = self._issues.get(port)
        return sig.value_at(cycle, 0) if sig is not None else 0

    def occupancy_series(self, channel: str) -> List[Tuple[int, int]]:
        return self._occ[channel].changes()

    @property
    def end_cycle(self) -> int:
        last = 0
        for sig in list(self._occ.values()) + list(self._issues.values()):
            if sig.times:
                sig._ensure_sorted()
                last = max(last, sig.times[-1])
        return last

    # -- VCD export ----------------------------------------------------------

    def to_vcd(self, *, module: str = "dae",
               timescale: str = "1 ns",
               comment: Optional[str] = None) -> str:
        """Serialize every channel-occupancy and port-issue timeline as a
        Value Change Dump (integer variables, one simulated cycle per
        timescale unit).  The output is deterministic for a
        deterministic run: no wall-clock dates, stable signal order.
        """
        sigs: List[Tuple[str, _Signal]] = []
        for name in sorted(self._occ):
            sigs.append((f"{_sanitize(name)}_occ", self._occ[name]))
        for name in sorted(self._issues):
            sigs.append((f"{_sanitize(name)}_issues", self._issues[name]))

        lines: List[str] = []
        if comment:
            lines += ["$comment", f"  {comment}", "$end"]
        lines += [f"$timescale {timescale} $end",
                  f"$scope module {_sanitize(module)} $end"]
        ids = []
        for i, (name, _) in enumerate(sigs):
            ident = vcd_identifier(i)
            ids.append(ident)
            lines.append(f"$var integer 32 {ident} {name} $end")
        lines += ["$upscope $end", "$enddefinitions $end"]

        # merge all change lists into one time-ordered dump
        events: Dict[int, List[Tuple[str, int]]] = {}
        initial: List[str] = []
        for (name, sig), ident in zip(sigs, ids):
            first = True
            for t, v in sig.changes():
                if first and t == 0:
                    initial.append(f"b{v:b} {ident}")
                    first = False
                    continue
                first = False
                events.setdefault(t, []).append((ident, v))
        lines.append("$dumpvars")
        seeded = {line.split()[-1] for line in initial}
        lines += initial
        for ident in ids:
            if ident not in seeded:
                lines.append(f"b0 {ident}")
        lines.append("$end")
        for t in sorted(events):
            lines.append(f"#{t}")
            for ident, v in events[t]:
                lines.append(f"b{v:b} {ident}")
        end = self.end_cycle
        if end not in events:
            lines.append(f"#{end}")
        return "\n".join(lines) + "\n"

    def write_vcd(self, path, **kw) -> None:
        from pathlib import Path
        Path(path).write_text(self.to_vcd(**kw))
