"""Explicit-decoupling programming model (DAE4HLS §3).

The port's copy of ``repro.core.dae``, unchanged but
for imports: host code, held bit for bit to the reference by
``tests/test_torch_dae_model.py``.

This module embeds the paper's four primitives

    stream_enq(channel, value)        stream_deq(channel, capacity)
    decouple_request(channel, addr)   decouple_response(channel, capacity)

as an executable program representation.  A *DAE program* is a set of
communicating sequential processes (the paper's Access / Execute loops,
instantiated as parallel execution units by the HLS `dataflow` pragma).
Each process is a Python generator that yields effect objects; the
scheduler in :mod:`repro_torch.core.simulator` executes them either

  * functionally (zero-latency memory) to check algorithmic correctness, or
  * under a cycle-level timing model (fixed-latency AXI or a MOMS-like
    coalescing memory) to reproduce the paper's cycle counts.

The same programs therefore serve as the paper-faithful reproduction and
as the oracle for the TPU adaptation in :mod:`repro_torch.core.decouple`.

Correctness rules (paper §5.1) are enforced structurally:

  * every ``decouple_request`` must be matched by exactly one
    ``decouple_response`` on the same channel (checked at program end);
  * a request blocks while the channel already has ``capacity`` responses
    in flight or queued (deadlock-freedom by capacity bounding, §5.4);
  * streams block on enq when full and on deq when empty; leftover stream
    entries at termination are reported as a conservation violation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Generator, Iterable, List, Optional, Tuple

__all__ = [
    "Channel",
    "LoadChannel",
    "StreamChannel",
    "Req",
    "Resp",
    "Enq",
    "Deq",
    "Delay",
    "Store",
    "StoreWait",
    "Halt",
    "Process",
    "DaeProgram",
    "ConservationError",
]


class ConservationError(RuntimeError):
    """Raised when request/response or enq/deq counts do not match."""


# ---------------------------------------------------------------------------
# Channels
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Channel:
    """Base point-to-point channel identified by name.

    ``capacity`` bounds the number of in-flight entries; the paper passes
    capacity at the dequeue site (Listing 1), we attach it to the channel
    object (equivalent, single consumer).
    """

    name: str
    capacity: int = 16

    def __post_init__(self) -> None:
        if self.capacity < 1:
            raise ValueError(f"channel {self.name}: capacity must be >= 1")


@dataclasses.dataclass
class StreamChannel(Channel):
    """In-order value FIFO between two program points (paper §3.1)."""


@dataclasses.dataclass
class LoadChannel(Channel):
    """Decoupled-load channel (paper §3.2).

    A request enqueues an *address*; the memory subsystem supplies the
    response.  ``port`` names the memory port (AXI interface / HBM stream)
    this channel issues on; multiple channels may share a port, which is
    exactly the Mergesort deadlock scenario of §5.3 that capacity
    bounding protects against.
    """

    port: str = "mem"


# ---------------------------------------------------------------------------
# Effects yielded by processes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Req:
    """decouple_request(channel, addr): issue a load for ``addr``."""

    channel: LoadChannel
    addr: int


@dataclasses.dataclass
class Resp:
    """decouple_response(channel): consume the oldest response (in order).

    The scheduler sends the loaded value back into the generator.
    """

    channel: LoadChannel


@dataclasses.dataclass
class Enq:
    """stream_enq(channel, value)."""

    channel: StreamChannel
    value: Any


@dataclasses.dataclass
class Deq:
    """stream_deq(channel) -> value (sent back into the generator)."""

    channel: StreamChannel


@dataclasses.dataclass
class Delay:
    """Occupy the process for ``cycles`` cycles of compute."""

    cycles: int = 1


@dataclasses.dataclass
class Store:
    """Issue a store of ``value`` to ``addr`` on ``port`` (fire and forget;

    ordering per static AXI ID is guaranteed by the memory model, paper
    §5.4)."""

    port: str
    addr: int
    value: Any


@dataclasses.dataclass
class StoreWait:
    """Wait until all previously issued stores on ``port`` are observable

    (the write-response channel of §5.4)."""

    port: str


@dataclasses.dataclass
class Halt:
    """Explicit end-of-process marker (optional; returning also halts)."""


Effect = Any
ProcessGen = Generator[Effect, Any, None]


@dataclasses.dataclass
class Process:
    """A named sequential process (one Access or Execute loop).

    ``gen`` accepts either a live generator (legacy, single-shot) or a
    zero-argument *factory* returning a fresh generator.  Factory-built
    processes are rebuildable: :meth:`fresh` re-instantiates them, which
    is what lets :meth:`DaeProgram.validate_channels` dry-run a program
    without consuming the generators the timed simulation will pump.
    Factories must create all of their mutable loop state inside the
    generator body (every builder in :mod:`repro_torch.core.workloads` does).

    ``ii`` is the initiation interval floor imposed by the *schedule* of
    the surrounding implementation: statically scheduled HLS (the Vitis
    baseline) often cannot reach II=1 for these loops (paper §7), while
    dynamically scheduled R-HLS can.  Every yielded effect costs at least
    ``ii`` cycles of issue occupancy on the process.
    """

    name: str
    gen: Any  # ProcessGen, or Callable[[], ProcessGen] (a factory)
    ii: int = 1
    factory: Optional[Callable[[], ProcessGen]] = None

    def __post_init__(self) -> None:
        # live generators are not callable; factories (generator
        # functions, partials, closures) are
        if self.factory is None and callable(self.gen):
            self.factory = self.gen
        if self.factory is not None and (self.gen is self.factory
                                         or self.gen is None):
            self.gen = self.factory()

    @property
    def rebuildable(self) -> bool:
        return self.factory is not None

    def fresh(self) -> "Process":
        """A new :class:`Process` with a freshly instantiated generator
        (requires a factory)."""
        if self.factory is None:
            raise ValueError(
                f"process {self.name!r} was built from a live generator "
                f"and cannot be re-instantiated; pass the generator "
                f"function itself to Process to make it rebuildable")
        return Process(self.name, self.factory, ii=self.ii)


@dataclasses.dataclass
class DaeProgram:
    """A set of processes plus the memory ports they reference."""

    name: str
    processes: List[Process]
    # map port name -> one of the simulator's memory models; filled by the
    # scheduler, declared here so programs are self-describing.
    ports: Tuple[str, ...] = ("mem",)

    @property
    def rebuildable(self) -> bool:
        """True when every process carries a generator factory, so the
        program can be validated and re-instantiated at will."""
        return all(p.rebuildable for p in self.processes)

    def fresh(self) -> "DaeProgram":
        """A new program with freshly instantiated process generators
        (requires every process to be rebuildable)."""
        return dataclasses.replace(
            self, processes=[p.fresh() for p in self.processes])

    def validate_channels(
        self,
        memories: Optional[Dict[str, Any]] = None,
        max_steps: int = 1_000_000,
    ) -> Dict[str, Channel]:
        """Discover every channel via a functional (zero-latency,
        unbounded-capacity) dry run and reject conflicting declarations.

        Channels are created dynamically, so static inspection cannot see
        them; instead the program is executed functionally — loads answer
        immediately from ``memories`` (``{port: indexable}``; absent ports
        serve 0), capacities never block.  Two distinct channel objects
        sharing a name must agree on type and capacity, otherwise the
        timed simulation would silently bind both to one FIFO whose
        capacity depends on scheduling order — that is the §5.3/§5.4
        misconfiguration this check exists to catch.

        Returns ``{name: channel}``.  Raises :class:`ValueError` on a
        conflict and :class:`ConservationError` if the dry run stalls or
        ends with undrained channels (§5.1).

        When every process carries a generator *factory* (pass the
        generator function to :class:`Process` instead of calling it),
        the dry run pumps fresh instances and leaves the program's own
        generators untouched — validate-then-simulate needs no rebuild.
        Legacy programs built from live generators are still accepted,
        but for them (and only them) the dry run consumes the
        generators: validate a freshly built program, then rebuild it
        before simulating.  The staged compiler in :mod:`repro_torch.compile`
        requires the factory form outright — its elaborate pass pumps
        this same loop twice and hands the untouched program back.
        """
        from repro_torch.core.simulator import Fused, Par  # deferred: no cycle

        memories = memories or {}
        seen: Dict[str, Channel] = {}
        fifos: Dict[str, List[Any]] = {}

        def note(ch: Channel) -> None:
            prev = seen.get(ch.name)
            if prev is None:
                seen[ch.name] = ch
            elif prev is not ch and (type(prev) is not type(ch)
                                     or prev.capacity != ch.capacity):
                raise ValueError(
                    f"channel {ch.name!r} declared twice with conflicting "
                    f"{type(prev).__name__}(capacity={prev.capacity}) vs "
                    f"{type(ch).__name__}(capacity={ch.capacity})")

        def ready(eff: Any) -> bool:
            if isinstance(eff, (Resp, Deq)):
                note(eff.channel)
                return bool(fifos.get(eff.channel.name))
            if isinstance(eff, Par):
                return all(ready(s) for s in eff.effects)
            if isinstance(eff, Fused):
                return ready(eff.first)
            return True

        def run(eff: Any) -> Any:
            if isinstance(eff, Req):
                note(eff.channel)
                data = memories.get(eff.channel.port)
                value = data[eff.addr] if data is not None else 0
                fifos.setdefault(eff.channel.name, []).append(value)
                return None
            if isinstance(eff, (Resp, Deq)):
                note(eff.channel)
                return fifos[eff.channel.name].pop(0)
            if isinstance(eff, Enq):
                note(eff.channel)
                fifos.setdefault(eff.channel.name, []).append(eff.value)
                return None
            if isinstance(eff, Par):
                return tuple(run(s) for s in eff.effects)
            if isinstance(eff, Fused):
                value = run(eff.first)
                follow = eff.then(value)
                if follow is not None:
                    if not ready(follow):
                        # §simulator contract: the follow-up must be
                        # non-blocking by construction
                        raise ConservationError(
                            f"{self.name}: Fused follow-up {follow!r} "
                            f"would block (empty channel) — fused effects "
                            f"must be non-blocking by construction")
                    run(follow)
                return value
            return None  # Delay / Store / StoreWait / Halt

        gens = [(p.name, p.factory() if p.rebuildable else p.gen)
                for p in self.processes]
        steps = 0

        def advance(i: int, send: Any) -> Any:
            """Resume process i; its next effect, or None when finished."""
            nonlocal steps
            steps += 1
            if steps > max_steps:
                raise ConservationError(
                    f"{self.name}: dry run exceeded {max_steps} steps")
            try:
                return gens[i][1].send(send)
            except StopIteration:
                return None

        pending = {i: advance(i, None) for i in range(len(gens))}
        pending = {i: e for i, e in pending.items() if e is not None}
        while pending:
            progressed = False
            for i in list(pending):
                eff = pending[i]
                while eff is not None and ready(eff):
                    progressed = True
                    if isinstance(eff, Halt):
                        eff = None
                        break
                    eff = advance(i, run(eff))
                if eff is None:
                    pending.pop(i)
                else:
                    pending[i] = eff
            if pending and not progressed:
                stuck = [gens[i][0] for i in pending]
                raise ConservationError(
                    f"{self.name}: functional dry run stalled "
                    f"(processes {stuck} blocked on empty channels)")
        leftover = {n: len(f) for n, f in fifos.items() if f}
        if leftover:
            raise ConservationError(
                f"{self.name}: dry run ended with undrained channels "
                f"{leftover}")
        return seen


# ---------------------------------------------------------------------------
# Helpers used by workload authors
# ---------------------------------------------------------------------------


def request_all(channel: LoadChannel, addrs: Iterable[int]) -> ProcessGen:
    """An Access loop that issues one request per address (paper Listing 2/3)."""

    for a in addrs:
        yield Req(channel, a)


def drain(channel: StreamChannel, n: int) -> ProcessGen:
    for _ in range(n):
        yield Deq(channel)
