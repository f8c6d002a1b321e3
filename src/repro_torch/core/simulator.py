"""Cycle-level simulator for DAE programs (paper §6 methodology).

The port's copy of ``repro.core.simulator``, unchanged but
for imports: host code, held bit for bit to the reference by
``tests/test_torch_dae_model.py``.

Executes a :class:`repro_torch.core.dae.DaeProgram` under a timing model and
returns cycle counts plus all stored results.  Two memory models are
provided, matching the paper's two evaluation setups:

  * :class:`FixedLatencyMemory` — the Verilator setup: every read and
    write takes a fixed ``latency`` (100 cycles in the paper), one
    request per cycle per port, bounded outstanding requests.
  * :class:`MomsMemory` — the Miss-Optimized Memory Subsystem + DRAMSim2
    setup (Table 3): request coalescing on cache lines, a small
    temporal-reuse cache, and a banked row-buffer DRAM model, with a cap
    on outstanding reads (64 in the paper).

The simulator is event driven (it skips idle cycles), so the multi-million
cycle baseline runs of Table 1 complete in well under a second.

Semantics enforced here (paper §5.1/§5.4):

  * loads on a channel complete **in issue order** (static AXI ID);
  * a ``Req`` blocks while ``capacity`` responses are already in flight
    or waiting — this is the buffer bound that makes sharing a port
    between channels deadlock-free;
  * stores become *observable* only when their write response returns;
    ``StoreWait`` models the end-of-accelerator state-edge merge;
  * if no process can make progress the simulator raises
    :class:`DeadlockError` (this reproduces the R-HLS-Stream mergesort
    deadlock of §6 when capacity rules are violated);
  * every request is answered exactly once and every stream entry is
    drained, else :class:`ConservationError` is raised at termination.

``Par`` bundles several effects into one issue slot — the dataflow
circuit equivalent of consuming the ``val`` and ``vec`` responses in the
same cycle in decoupled SPMV (paper Listing 2).

Multi-instance execution: the scheduler is an engine
(:class:`SharedMemoryEngine`) that runs **N concurrent program
instances against one shared memory system** — the contention regime
that motivates the paper's capacity bounding.  Each instance keeps its
own channel namespace, store results, and cycle count; memory ports are
either *private* to an instance or *shared*, in which case all
instances compete for the port's one-issue-per-cycle slot (round-robin
arbitration on ties) and for the memory model's outstanding-request
budget.  :func:`simulate` is the single-instance wrapper and is
bit-exact with the pre-engine scheduler.  An optional
:class:`repro_torch.core.trace.Tracer` streams per-channel occupancy,
request-latency histograms, and port-utilization timelines.

Two scheduler implementations share one semantics:

  * ``engine="event"`` (default) — an event-driven scheduler: blocked
    processes sit in wait-sets keyed by the channel/port event that
    could unblock them (FIFO push/pop, port issue, store completion)
    and are re-examined only when that event fires; the no-progress
    clock jump comes from a retry-time heap instead of an O(procs)
    sweep, and jumped time is a lazily applied global floor.  Scheduler
    passes map 1:1 onto the polling scheduler's passes, so the
    round-robin arbitration rotation — and therefore every cycle count,
    store, trace record, and deadlock message — is bit-exact with
    ``engine="polling"`` (pinned by ``tests/test_parity.py``).
  * ``engine="polling"`` — the legacy pass-based scheduler that
    re-checks readiness of every live process on every pass.  Kept as
    the differential-testing oracle; O(procs) per pass, so large
    multi-tenant sweeps are much slower on it.
"""

from __future__ import annotations

import dataclasses
import heapq
import operator
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.dae import (
    Channel,
    ConservationError,
    DaeProgram,
    Delay,
    Deq,
    Enq,
    Halt,
    LoadChannel,
    Process,
    Req,
    Resp,
    Store,
    StoreWait,
    StreamChannel,
)
from repro_torch.channels.sim import SimChannel

__all__ = [
    "ENGINES",
    "FixedLatencyMemory",
    "MomsMemory",
    "Par",
    "SimResult",
    "EngineInstance",
    "EngineResult",
    "SharedMemoryEngine",
    "DeadlockError",
    "simulate",
]

INF = float("inf")


class DeadlockError(RuntimeError):
    pass


@dataclasses.dataclass
class Par:
    """Execute several effects in a single issue slot (same cycle).

    Blocks until *all* sub-effects are ready; the value sent back into
    the generator is a tuple with one entry per sub-effect (``None`` for
    effects that produce no value).
    """

    effects: Sequence[Any]


@dataclasses.dataclass
class Fused:
    """A dataflow operator: consume ``first`` and *in the same cycle* run

    ``then(value)`` which may return a follow-up effect (Store/Enq/Req/
    Par/Fused) or ``None``.  This models combinational paths in a
    dataflow circuit — e.g. the copy loop's load-response feeding the
    store port at II=1, or mergesort's response feeding the comparison
    that selects the store value (paper Listing 3).

    Readiness is checked on ``first`` only; the follow-up must be
    non-blocking by construction (capacity freed by the consume in the
    same slot, as in Listing 4's request/enq after response/deq).
    """

    first: Any
    then: Any  # Callable[[Any], Optional[effect]]


# ---------------------------------------------------------------------------
# Memory models
# ---------------------------------------------------------------------------


class MemoryModel:
    """Interface: ``access(addr, t_issue) -> (t_complete, value)``."""

    def __init__(self, data: Any, max_outstanding: int = 64):
        self.data = data
        self.max_outstanding = max_outstanding
        self._inflight: List[float] = []  # completion-time heap (reads)
        self.reads = 0
        self.writes = 0

    def free_slot_at(self, t: float) -> float:
        """Earliest time >= t a new read may issue given the
        outstanding-request cap."""
        while self._inflight and self._inflight[0] <= t:
            heapq.heappop(self._inflight)
        if len(self._inflight) < self.max_outstanding:
            return t
        return self._inflight[0]

    def _commit(self, t_complete: float) -> None:
        heapq.heappush(self._inflight, t_complete)

    def read_value(self, addr: int) -> Any:
        return self.data[addr]

    def access(self, addr: int, t: float) -> Tuple[float, Any]:
        raise NotImplementedError

    def write_latency(self) -> float:
        raise NotImplementedError


class FixedLatencyMemory(MemoryModel):
    """Uniform fixed-latency memory (the paper's 100-cycle Verilator model)."""

    def __init__(self, data: Any, latency: int = 100, max_outstanding: int = 64):
        super().__init__(data, max_outstanding)
        self.latency = latency

    def access(self, addr: int, t: float) -> Tuple[float, Any]:
        self.reads += 1
        t_done = t + self.latency
        self._commit(t_done)
        return t_done, self.read_value(addr)

    def write_latency(self) -> float:
        return self.latency


class MomsMemory(MemoryModel):
    """Miss-optimized memory subsystem (Asiatici [2]) + row-buffer DRAM.

    * word addresses are grouped into ``line_words``-word cache lines;
    * a request to a line already in flight coalesces: it completes when
      the in-flight line lands (+1 cycle response serialization);
    * a small ``cache_kib`` FIFO cache of recently landed lines serves
      repeats at ``hit_latency``;
    * misses pay the DRAM model: per-bank open-row tracking, ``t_row_hit``
      vs ``t_row_miss``, plus bank busy time.
    """

    def __init__(
        self,
        data: Any,
        line_words: int = 16,
        cache_kib: int = 128,
        word_bytes: int = 4,
        hit_latency: int = 12,
        t_row_hit: int = 45,
        t_row_miss: int = 110,
        banks: int = 8,
        row_words: int = 256,
        max_outstanding: int = 64,
    ):
        super().__init__(data, max_outstanding)
        self.line_words = line_words
        self.hit_latency = hit_latency
        self.t_row_hit = t_row_hit
        self.t_row_miss = t_row_miss
        self.banks = banks
        self.row_words = row_words
        self.n_cache_lines = max(1, (cache_kib * 1024) // (line_words * word_bytes))
        self._inflight_lines: Dict[int, float] = {}
        self._cache: "deque[int]" = deque()
        self._cache_set: set = set()
        self._open_row: Dict[int, int] = {}
        self._bank_free: Dict[int, float] = {}
        self.stats = {"coalesced": 0, "hits": 0, "row_hits": 0, "row_misses": 0}

    def _dram_access(self, line: int, t: float) -> float:
        bank = line % self.banks
        row = (line * self.line_words) // self.row_words
        t_bank = max(t, self._bank_free.get(bank, 0.0))
        if self._open_row.get(bank) == row:
            dt = self.t_row_hit
            self.stats["row_hits"] += 1
        else:
            dt = self.t_row_miss
            self.stats["row_misses"] += 1
            self._open_row[bank] = row
        self._bank_free[bank] = t_bank + 4  # burst occupancy
        return t_bank + dt

    def _cache_insert(self, line: int) -> None:
        if line in self._cache_set:
            return
        self._cache.append(line)
        self._cache_set.add(line)
        while len(self._cache) > self.n_cache_lines:
            old = self._cache.popleft()
            self._cache_set.discard(old)

    def access(self, addr: int, t: float) -> Tuple[float, Any]:
        self.reads += 1
        line = addr // self.line_words
        tf = self._inflight_lines.get(line)
        if tf is not None and tf > t:
            self.stats["coalesced"] += 1
            return tf + 1, self.read_value(addr)
        if line in self._cache_set:
            self.stats["hits"] += 1
            return t + self.hit_latency, self.read_value(addr)
        t_done = self._dram_access(line, t)
        self._commit(t_done)
        self._inflight_lines[line] = t_done
        self._cache_insert(line)
        return t_done, self.read_value(addr)

    def write_latency(self) -> float:
        return self.t_row_miss


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimResult:
    cycles: int
    stores: Dict[str, Dict[int, Any]]
    counts: Dict[str, int]
    mem_reads: Dict[str, int]

    def stored_array(self, port: str, n: int) -> List[Any]:
        s = self.stores.get(port, {})
        return [s.get(i) for i in range(n)]


# Channel state is the sim transport of the shared repro_torch.channels
# protocol: a timed (ready_time, value) FIFO with the §5.1 conservation
# counters and the event engine's wake keys.  Both engines mutate it
# only through push_timed/pop_timed, which emit the shared occupancy
# vocabulary; the readiness oracles below still peek ``st.fifo``
# directly (scheduler hot path).
_ChanState = SimChannel


class _Proc:
    __slots__ = ("proc", "time", "effect", "send", "done", "blocked_on",
                 "pos", "inst", "iidx", "gen", "vsnap", "stamp", "waits",
                 "teff", "tkeys")

    def __init__(self, proc: Process):
        self.proc = proc
        self.time = 0.0
        self.effect: Any = None
        self.send: Any = None
        self.done = False
        self.blocked_on: Optional[str] = None
        # event-engine bookkeeping (unused by the polling scheduler)
        self.pos = 0                 # index into the engine's pairs list
        self.inst: Any = None        # owning _Inst
        self.iidx = 0                # owning instance index (arbitration)
        self.gen = proc.gen          # bound generator (pump hot path)
        self.vsnap: Any = None       # port-version snapshot under which
                                     # the cached retry was computed
        self.stamp = 0               # invalidates stale retry-heap entries
        self.waits: Any = None       # (wake_keys, dirty_keys) while parked
        self.teff: Any = None        # effect the trigger-key cache is for
        self.tkeys: Any = None       # cached (wake_keys, dirty_keys)


@dataclasses.dataclass
class EngineInstance:
    """One tenant of the engine: a program plus its *private* memory
    ports.  Ports not listed in ``memories`` resolve to the engine's
    shared memory system — the instance competes with every other tenant
    for those ports' issue slots and outstanding-request budget."""

    name: str
    program: DaeProgram
    memories: Dict[str, MemoryModel] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class EngineResult:
    """Per-instance results plus the shared-run aggregates.

    ``cycles`` is the makespan (slowest instance); ``instances`` holds
    one :class:`SimResult` per tenant in submission order.  ``trace`` is
    the :class:`repro_torch.core.trace.TraceSummary` when a tracer was
    attached, else ``None``.  ``events`` counts executed effects and
    ``passes`` scheduler passes — identical across the event and
    polling engines (a parity invariant); events/second is the
    throughput ``benchmarks.engine_bench`` compares.
    """

    cycles: int
    instances: List[SimResult]
    trace: Optional[Any] = None
    events: int = 0
    passes: int = 0


class _Inst:
    """Engine-internal per-tenant state: its own channel namespace,
    store results, and store-completion tracking."""

    __slots__ = ("name", "index", "private", "procs", "chans",
                 "port_last_store", "stores", "port_reads", "portcache")

    def __init__(self, name: str, index: int, program: DaeProgram,
                 private: Dict[str, MemoryModel]):
        self.name = name
        self.index = index
        self.private = private
        self.procs = [_Proc(p) for p in program.processes]
        self.chans: Dict[str, _ChanState] = {}
        self.port_last_store: Dict[str, float] = {}
        self.stores: Dict[str, Dict[int, Any]] = {}
        self.port_reads: Dict[str, int] = {}
        # event-engine cache: port -> (mem, owner, pni_key, issue_key,
        # mem_key, store_key, trace_label); see _port_ev
        self.portcache: Dict[str, Tuple] = {}

    def chan(self, c: Channel) -> _ChanState:
        st = self.chans.get(c.name)
        if st is None:
            st = self.chans[c.name] = _ChanState()
        return st


class _Ctx:
    """Shared engine state: the shared memory system, per-physical-port
    issue serialization, and the (optional) tracer."""

    def __init__(self, memories: Dict[str, MemoryModel], trace: Any = None):
        self.memories = memories
        # keyed by (owner, port): owner "" for shared ports, else the
        # instance name — two tenants' private "out" ports must not
        # serialize against each other
        self.port_next_issue: Dict[Tuple, float] = {}
        self.trace = trace
        # side-channel from _ready_ev: a *blocked* Par evaluation sets
        # this when one of its Req or StoreWait subs was ready (the
        # non-monotone parks the event scheduler watches eagerly);
        # per-run state so concurrent engine runs in one process cannot
        # race on it
        self.par_ready_req = False

    def mem(self, inst: _Inst, port: str) -> Tuple[MemoryModel, str]:
        """Resolve ``port`` for ``inst``: private first, then shared.
        Returns ``(memory, owner)`` with owner "" for shared ports."""
        m = inst.private.get(port)
        if m is not None:
            return m, inst.name
        m = self.memories.get(port)
        if m is None:
            raise KeyError(
                f"program references port {port!r} with no memory model bound"
            )
        return m, ""


def _port_label(owner: str, port: str) -> str:
    return f"{owner}/{port}" if owner else port


def _readiness(ctx: _Ctx, inst: _Inst, eff: Any, t: float
               ) -> Tuple[bool, float, str]:
    """Can ``eff`` execute at time t?  -> (ok, retry_time, reason)."""
    if isinstance(eff, (Delay, Halt, Store)):
        return True, t, ""
    if isinstance(eff, Req):
        c = eff.channel
        st = inst.chan(c)
        if len(st.fifo) >= c.capacity:
            # clears only when the consumer takes a response (unknown time);
            # if the front entry is still in flight, its landing time is a
            # usable lower bound for the global-time jump.
            front_ready = st.fifo[0][0] if st.fifo else INF
            retry = front_ready if front_ready > t else INF
            return False, retry, f"cap:{c.name}"
        mem, owner = ctx.mem(inst, c.port)
        t_issue = max(t, ctx.port_next_issue.get((owner, c.port), 0.0))
        slot = mem.free_slot_at(t_issue)
        if slot > t:
            return False, slot, f"mshr:{c.port}"
        return True, t, ""
    if isinstance(eff, Resp):
        st = inst.chan(eff.channel)
        if not st.fifo:
            return False, INF, f"resp:{eff.channel.name}"
        ready = st.fifo[0][0]
        if ready > t:
            return False, ready, f"resp-wait:{eff.channel.name}"
        return True, t, ""
    if isinstance(eff, Enq):
        st = inst.chan(eff.channel)
        if len(st.fifo) >= eff.channel.capacity:
            return False, INF, f"full:{eff.channel.name}"
        return True, t, ""
    if isinstance(eff, Deq):
        st = inst.chan(eff.channel)
        if not st.fifo:
            return False, INF, f"empty:{eff.channel.name}"
        ready = st.fifo[0][0]
        if ready > t:
            return False, ready, f"deq-wait:{eff.channel.name}"
        return True, t, ""
    if isinstance(eff, StoreWait):
        done_at = inst.port_last_store.get(eff.port, 0.0)
        if done_at > t:
            return False, done_at, f"storewait:{eff.port}"
        return True, t, ""
    if isinstance(eff, Par):
        retries: List[float] = []
        reasons: List[str] = []
        for sub in eff.effects:
            ok, retry, reason = _readiness(ctx, inst, sub, t)
            if not ok:
                retries.append(retry)
                reasons.append(reason)
        if reasons:
            finite = [r for r in retries if r is not INF]
            # conservative: re-check at the earliest time any blocker could
            # clear; unknown (INF) blockers are re-checked whenever another
            # process makes progress.
            return False, (min(finite) if finite else INF), "&".join(reasons)
        return True, t, ""
    if isinstance(eff, Fused):
        return _readiness(ctx, inst, eff.first, t)
    raise TypeError(f"unknown effect {eff!r}")


def _execute(ctx: _Ctx, inst: _Inst, eff: Any, t: float) -> Any:
    """Execute a ready effect at time t; returns the value to send."""
    if isinstance(eff, (Delay, Halt)):
        return None
    if isinstance(eff, Req):
        c = eff.channel
        st = inst.chan(c)
        mem, owner = ctx.mem(inst, c.port)
        key = (owner, c.port)
        t_issue = max(t, ctx.port_next_issue.get(key, 0.0))
        t_done, value = mem.access(eff.addr, t_issue)
        ctx.port_next_issue[key] = t_issue + 1.0
        inst.port_reads[c.port] = inst.port_reads.get(c.port, 0) + 1
        if ctx.trace is not None:
            ctx.trace.on_request(inst.name, c.name,
                                 _port_label(owner, c.port), t_issue, t_done)
        st.push_timed(t_done, value, "req", ctx.trace, inst.name, c.name, t)
        return None
    if isinstance(eff, Resp):
        st = inst.chan(eff.channel)
        return st.pop_timed("resp", ctx.trace, inst.name,
                            eff.channel.name, t)
    if isinstance(eff, Enq):
        st = inst.chan(eff.channel)
        st.push_timed(t + 1.0, eff.value, "enq", ctx.trace, inst.name,
                      eff.channel.name, t)
        return None
    if isinstance(eff, Deq):
        st = inst.chan(eff.channel)
        return st.pop_timed("deq", ctx.trace, inst.name,
                            eff.channel.name, t)
    if isinstance(eff, Store):
        port = eff.port
        mem, owner = ctx.mem(inst, port)
        mem.writes += 1
        key = (owner, port)
        t_issue = max(t, ctx.port_next_issue.get(key, 0.0))
        ctx.port_next_issue[key] = t_issue + 1.0
        t_done = t_issue + mem.write_latency()
        inst.port_last_store[port] = max(
            inst.port_last_store.get(port, 0.0), t_done)
        inst.stores.setdefault(port, {})[eff.addr] = eff.value
        try:
            mem.data[eff.addr] = eff.value
        except (TypeError, IndexError, KeyError):
            pass
        if ctx.trace is not None:
            ctx.trace.on_store(inst.name, _port_label(owner, port), t_issue)
        return None
    if isinstance(eff, StoreWait):
        return None
    if isinstance(eff, Par):
        return tuple(_execute(ctx, inst, sub, t) for sub in eff.effects)
    if isinstance(eff, Fused):
        value = _execute(ctx, inst, eff.first, t)
        follow = eff.then(value)
        if follow is not None:
            _execute(ctx, inst, follow, t)
        return value
    raise TypeError(f"unknown effect {eff!r}")


# ---------------------------------------------------------------------------
# Event-engine fast path.  _ready_ev/_exec_ev are semantically identical
# to the legacy _readiness/_execute pair above (same retry values, reason
# strings, trace records, and state transitions — pinned against each
# other by tests/test_parity.py) but are restructured for the event
# scheduler's hot loop: exact-type dispatch instead of isinstance
# cascades, per-instance port-resolution caches, pre-built wake-event
# key tuples, and wake-event emission threaded through an explicit list.
# ---------------------------------------------------------------------------


_proc_pos = operator.attrgetter("pos")


def _chan_ev(inst: _Inst, c: Channel) -> _ChanState:
    st = inst.chans.get(c.name)
    if st is None:
        st = inst.chans[c.name] = _ChanState()
    if st.push_key is None:
        st.push_key = ("push", inst.index, c.name)
        st.pop_key = ("pop", inst.index, c.name)
    return st


def _port_ev(ctx: _Ctx, inst: _Inst, port: str) -> Tuple:
    """Cached port resolution: ``(mem, owner, pni_key, issue_key,
    mem_key, store_key, trace_label)``.  Safe to cache because port
    bindings are fixed for the lifetime of an engine run."""
    e = inst.portcache.get(port)
    if e is None:
        mem = inst.private.get(port)
        if mem is not None:
            owner = inst.name
        else:
            mem = ctx.memories.get(port)
            if mem is None:
                raise KeyError(
                    f"program references port {port!r} with no memory "
                    f"model bound"
                )
            owner = ""
        e = inst.portcache[port] = (
            mem, owner, (owner, port), ("issue", owner, port),
            ("mem", id(mem)), ("store", inst.index, port),
            _port_label(owner, port))
    return e


def _ready_ev(ctx: _Ctx, inst: _Inst, eff: Any, t: float) -> Optional[float]:
    """Can ``eff`` execute at time t?  ``None`` when ready, else the
    retry time (INF for state-change-only blockers).

    Unlike the legacy :func:`_readiness` oracle this does not build the
    blocked-reason string: in the event engine a reason is only ever
    observed inside a deadlock message, and a deadlock is a global
    fixpoint — no state can have changed since each process parked — so
    the messages are derived fresh through the legacy oracle at that
    point (see ``_deadlock_event``) and are guaranteed identical.
    """
    cls = eff.__class__
    while cls is Fused:
        eff = eff.first
        cls = eff.__class__
    if cls is Resp:
        fifo = _chan_ev(inst, eff.channel).fifo
        if not fifo:
            return INF
        ready = fifo[0][0]
        if ready > t:
            return ready
        return None
    if cls is Req:
        c = eff.channel
        fifo = _chan_ev(inst, c).fifo
        if len(fifo) >= c.capacity:
            front_ready = fifo[0][0] if fifo else INF
            return front_ready if front_ready > t else INF
        entry = _port_ev(ctx, inst, c.port)
        t_issue = ctx.port_next_issue.get(entry[2], 0.0)
        if t_issue < t:
            t_issue = t
        slot = entry[0].free_slot_at(t_issue)
        if slot > t:
            return slot
        return None
    if cls is Par:
        # blocked iff any sub is; retry = min finite over blocked subs
        blocked = False
        r_min: Optional[float] = None
        for sub in eff.effects:
            r = _ready_ev(ctx, inst, sub, t)
            if r is None:
                sc = sub.__class__
                while sc is Fused:
                    sub = sub.first
                    sc = sub.__class__
                if sc is Req or sc is StoreWait:
                    # a ready Req (or StoreWait) sub inside a blocked
                    # Par: someone else's issue (store) can later
                    # mshr-block (write-gate) it, handing the Par a new,
                    # possibly smaller finite retry — the non-monotone
                    # park the jump must watch eagerly
                    ctx.par_ready_req = True
                continue
            blocked = True
            if r is not INF and (r_min is None or r < r_min):
                r_min = r
        if not blocked:
            return None
        return r_min if r_min is not None else INF
    if cls is Deq:
        fifo = _chan_ev(inst, eff.channel).fifo
        if not fifo:
            return INF
        ready = fifo[0][0]
        if ready > t:
            return ready
        return None
    if cls is Enq:
        st = _chan_ev(inst, eff.channel)
        if len(st.fifo) >= eff.channel.capacity:
            return INF
        return None
    if cls is Delay or cls is Store or cls is Halt:
        return None
    if cls is StoreWait:
        done_at = inst.port_last_store.get(eff.port, 0.0)
        if done_at > t:
            return done_at
        return None
    raise TypeError(f"unknown effect {eff!r}")


def _exec_ev(ctx: _Ctx, inst: _Inst, eff: Any, t: float,
             ev: List[Tuple]) -> Any:
    """Execute a ready effect at time t, appending the wake-event keys
    of every state change to ``ev``; returns the value to send."""
    cls = eff.__class__
    if cls is Fused:
        value = _exec_ev(ctx, inst, eff.first, t, ev)
        follow = eff.then(value)
        if follow is not None:
            _exec_ev(ctx, inst, follow, t, ev)
        return value
    if cls is Resp:
        st = _chan_ev(inst, eff.channel)
        ev.append(st.pop_key)
        return st.pop_timed("resp", ctx.trace, inst.name,
                            eff.channel.name, t)
    if cls is Req:
        c = eff.channel
        st = _chan_ev(inst, c)
        mem, _, pni_key, issue_key, mem_key, _, label = \
            _port_ev(ctx, inst, c.port)
        pni = ctx.port_next_issue
        t_issue = pni.get(pni_key, 0.0)
        if t_issue < t:
            t_issue = t
        t_done, value = mem.access(eff.addr, t_issue)
        pni[pni_key] = t_issue + 1.0
        inst.port_reads[c.port] = inst.port_reads.get(c.port, 0) + 1
        ev.append(st.push_key)
        ev.append(issue_key)
        ev.append(mem_key)
        if ctx.trace is not None:
            ctx.trace.on_request(inst.name, c.name, label, t_issue, t_done)
        st.push_timed(t_done, value, "req", ctx.trace, inst.name, c.name, t)
        return None
    if cls is Par:
        return tuple([_exec_ev(ctx, inst, sub, t, ev)
                      for sub in eff.effects])
    if cls is Enq:
        st = _chan_ev(inst, eff.channel)
        ev.append(st.push_key)
        st.push_timed(t + 1.0, eff.value, "enq", ctx.trace, inst.name,
                      eff.channel.name, t)
        return None
    if cls is Deq:
        st = _chan_ev(inst, eff.channel)
        ev.append(st.pop_key)
        value = st.pop_timed("deq", ctx.trace, inst.name,
                             eff.channel.name, t)
        return value
    if cls is Store:
        port = eff.port
        mem, _, pni_key, issue_key, _, store_key, label = \
            _port_ev(ctx, inst, port)
        mem.writes += 1
        pni = ctx.port_next_issue
        t_issue = pni.get(pni_key, 0.0)
        if t_issue < t:
            t_issue = t
        pni[pni_key] = t_issue + 1.0
        t_done = t_issue + mem.write_latency()
        pls = inst.port_last_store
        prev = pls.get(port, 0.0)
        if t_done > prev:
            pls[port] = t_done
        inst.stores.setdefault(port, {})[eff.addr] = eff.value
        try:
            mem.data[eff.addr] = eff.value
        except (TypeError, IndexError, KeyError):
            pass
        ev.append(issue_key)
        ev.append(store_key)
        if ctx.trace is not None:
            ctx.trace.on_store(inst.name, label, t_issue)
        return None
    if cls is Delay or cls is Halt or cls is StoreWait:
        return None
    raise TypeError(f"unknown effect {eff!r}")


def _collect_triggers(ctx: _Ctx, inst: _Inst, eff: Any, wake: set,
                      dirty: set) -> None:
    """Wait-set keys for a blocked ``eff``, split by what the event can
    do to it.

    ``wake`` keys are state changes that could make the effect *ready*
    (a FIFO push for an empty-blocked consumer, a pop for a full-blocked
    producer or an in-order head swap) — they re-examine the process
    immediately, at its polling-scheduler position in the pass.

    ``dirty`` keys can only move the effect's *retry time* (a port issue
    pushes ``port_next_issue``/the MSHR heap later; a store pushes the
    write-response edge later) — they never unblock anything, so the
    re-examination is deferred to the next no-progress pass, where the
    clock jump needs fresh retries to stay in lockstep with the polling
    scheduler's freshly computed minimum.

    For a single ``Req``/``StoreWait`` a dirty event can only *increase*
    the retry, so the jump may validate cached values lazily from the
    heap minimum upward.  A ``Par`` with a ``Req`` or ``StoreWait`` sub
    that is *ready* at park time breaks that monotonicity: a port issue
    (store) can turn the ready sub into an mshr-blocked (write-gated)
    one, giving the Par a new, possibly much *smaller* finite retry.
    ``_ready_ev`` flags that case through ``ctx.par_ready_req`` and the
    scheduler puts such parks on an eager per-jump watch list.  (A sub
    *blocked* at park time cannot turn ready without a wake event, so
    its contribution stays monotone.)
    """
    cls = eff.__class__
    if cls is Req:
        st = _chan_ev(inst, eff.channel)
        wake.add(st.pop_key)
        entry = _port_ev(ctx, inst, eff.channel.port)
        dirty.add(entry[3])
        dirty.add(entry[4])
        return
    if cls is Resp or cls is Deq:
        st = _chan_ev(inst, eff.channel)
        wake.add(st.push_key)
        wake.add(st.pop_key)
    elif cls is Enq:
        wake.add(_chan_ev(inst, eff.channel).pop_key)
    elif cls is StoreWait:
        dirty.add(_port_ev(ctx, inst, eff.port)[5])
    elif cls is Par:
        for sub in eff.effects:
            _collect_triggers(ctx, inst, sub, wake, dirty)
    elif cls is Fused:
        _collect_triggers(ctx, inst, eff.first, wake, dirty)
    # Delay / Halt / Store are always ready and never park in a wait-set


ENGINES = ("event", "polling")


class SharedMemoryEngine:
    """Execute N concurrent DAE program instances against one shared
    memory system.

    * **Round-robin port arbitration** — live processes are scheduled in
      local-time order; among processes tied at the same time the
      starting instance rotates every scheduler pass, so no tenant can
      persistently win a shared port's issue slot.  With one instance
      the order degenerates to the legacy scheduler's, making
      :func:`simulate` bit-exact with the pre-engine implementation.
    * **Per-instance cycle accounting** — each tenant's cycle count is
      the completion time of its own processes and stores; the engine's
      ``cycles`` is the makespan.
    * **Shared outstanding-request budget** — a shared port's
      ``max_outstanding`` (the MOMS MSHR budget) is one pool all
      tenants draw from, which is exactly the §5.4 contention regime.

    Conservation (§5.1) is checked per instance at termination; a global
    scheduling fixpoint with no runnable process raises
    :class:`DeadlockError` naming every blocked process.

    ``engine`` selects the scheduler implementation: ``"event"`` (the
    default, event-driven) or ``"polling"`` (the legacy pass-based
    oracle).  Both produce bit-identical results; see the module
    docstring.
    """

    def __init__(self, instances: Sequence[EngineInstance],
                 shared_memories: Optional[Dict[str, MemoryModel]] = None,
                 *, tracer: Any = None, max_steps: int = 500_000_000,
                 engine: str = "event"):
        if not instances:
            raise ValueError("SharedMemoryEngine needs at least one instance")
        names = [i.name for i in instances]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate instance names: {names}")
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} (choose from "
                             f"{ENGINES})")
        self.instances = list(instances)
        self.shared = dict(shared_memories or {})
        self.tracer = tracer
        self.max_steps = max_steps
        self.engine = engine

    def run(self) -> EngineResult:
        insts = [_Inst(spec.name, i, spec.program, spec.memories)
                 for i, spec in enumerate(self.instances)]
        pairs = [(inst, p) for inst in insts for p in inst.procs]
        ctx = _Ctx(self.shared, self.tracer)
        if self.engine == "polling":
            n_events, passes = self._run_polling(insts, pairs, ctx)
        else:
            n_events, passes = self._run_event(insts, pairs, ctx)
        results = [self._finalize(inst) for inst in insts]
        makespan = max([r.cycles for r in results] + [0])
        trace = self.tracer.summary() if self.tracer is not None else None
        return EngineResult(cycles=makespan, instances=results, trace=trace,
                            events=n_events, passes=passes)

    def _deadlock_event(self, ctx, live, floor) -> None:
        """Deadlock from the event scheduler: derive each blocked
        process's reason fresh through the legacy oracle (a deadlock is
        a fixpoint, so nothing has changed since each process parked and
        the strings match the polling scheduler's exactly)."""
        for inst, p in live:
            t = p.time
            _, _, reason = _readiness(ctx, inst, p.effect,
                                      t if t > floor else floor)
            p.blocked_on = reason
        self._deadlock(live)

    def _deadlock(self, live) -> None:
        n_inst = len(self.instances)
        if n_inst == 1:
            blocked = {p.proc.name: p.blocked_on for _, p in live}
            raise DeadlockError(
                f"deadlock in program "
                f"{self.instances[0].program.name!r}: {blocked}")
        blocked = {f"{inst.name}:{p.proc.name}": p.blocked_on
                   for inst, p in live}
        raise DeadlockError(
            f"deadlock across {n_inst} instances: {blocked}")

    def _run_polling(self, insts, pairs, ctx) -> Tuple[int, int]:
        """Legacy pass-based scheduler: every pass re-pumps, re-sorts,
        and re-checks readiness of every live process."""
        n_inst = len(insts)
        n_events = 0
        steps = 0
        rotation = 0
        while True:
            steps += 1
            if steps > self.max_steps:
                raise RuntimeError("simulation step limit exceeded")

            for inst, p in pairs:
                if not p.done and p.effect is None:
                    try:
                        p.effect = p.proc.gen.send(p.send)
                        p.send = None
                    except StopIteration:
                        p.done = True
            live = [(inst, p) for inst, p in pairs if not p.done]
            if not live:
                break

            if n_inst > 1:
                rot = rotation
                order = sorted(live, key=lambda ip: (
                    ip[1].time, (ip[0].index - rot) % n_inst))
            else:
                order = sorted(live, key=lambda ip: ip[1].time)
            rotation += 1

            progressed = False
            best_retry = INF
            for inst, p in order:
                eff, t, ii = p.effect, p.time, p.proc.ii
                ok, retry, reason = _readiness(ctx, inst, eff, t)
                if not ok:
                    best_retry = min(best_retry, retry)
                    p.blocked_on = reason
                    continue
                p.send = _execute(ctx, inst, eff, t)
                n_events += 1
                if isinstance(eff, Delay):
                    p.time = t + max(eff.cycles, 0)
                else:
                    p.time = t + ii
                if isinstance(eff, Halt):
                    p.done = True
                p.effect = None
                p.blocked_on = None
                progressed = True

            if not progressed:
                if best_retry is INF:
                    self._deadlock(live)
                for inst, p in pairs:
                    if not p.done and p.time < best_retry:
                        p.time = best_retry
        return n_events, steps

    def _run_event(self, insts, pairs, ctx) -> Tuple[int, int]:
        """Event-driven scheduler, bit-exact with :meth:`_run_polling`.

        Equivalence argument (verified cell-by-cell by
        ``tests/test_parity.py``):

        * **passes map 1:1** — each iteration of the outer loop below
          corresponds to one polling pass, so the round-robin rotation
          index (``pass_no - 1``) agrees with the polling scheduler's
          per-pass ``rotation`` counter, tie-breaking identically;
        * **candidate sufficiency** — a blocked process's readiness (and
          its retry time) can only change when a wait-set trigger from
          :func:`_collect_triggers` fires or when the no-progress jump
          reaches its cached retry, so processes outside the pass's
          candidate heap would re-block exactly as they did last time
          and are safe to skip;
        * **in-pass ordering** — candidates pop off a heap keyed
          ``(local_time, rotated_instance_index, pairs_position)``, the
          polling scheduler's stable sort key.  A process woken by an
          event *behind* the current key joins this pass's heap (the
          polling sweep would reach it later in the same pass); one
          woken *at or before* the current key waits for the next pass
          (the sweep already passed it);
        * **lazy clock floor** — the no-progress jump advances a global
          ``floor`` instead of rewriting every process's clock;
          effective time is ``max(local, floor)``, materialized on
          execution.  The jump target comes from a stamp-invalidated
          heap of cached retry times, which equals the polling
          scheduler's fresh minimum because every event that could
          change a retry also wakes its process for re-examination.
        """
        n_inst = len(insts)
        max_steps = self.max_steps
        procs: List[_Proc] = []
        for pos, (inst, p) in enumerate(pairs):
            p.pos = pos
            p.inst = inst
            p.iidx = inst.index
            procs.append(p)
        live_count = len(pairs)
        # wake-sets: state changes that can make a parked proc ready
        waiters: Dict[Tuple, Dict[_Proc, None]] = {}
        # port-state version counters: bumped O(1) per issue/store; a
        # parked proc snapshots the versions its retry was computed
        # under, and the jump refreshes any proc whose snapshot is stale
        vers: Dict[Tuple, int] = {}
        # parked procs whose retry is non-monotone under port events (a
        # Par with a Req sub — see _collect_triggers): version-checked
        # eagerly at every jump, because a stale cached retry may be
        # *larger* than the fresh one and the lazy heap validation below
        # would then miss the true minimum
        watch: Dict[_Proc, None] = {}
        retry_heap: List[Tuple[float, int, int]] = []  # (retry, pos, stamp)
        # stale entries (superseded stamps) are dropped lazily at jumps;
        # compact when they pile up so heap ops stay O(log live-entries)
        compact_at = max(64, 8 * len(pairs))
        floor = 0.0
        pass_no = 0
        n_events = 0
        to_pump: List[_Proc] = list(procs)
        next_cand: List[_Proc] = []
        ev: List[Tuple] = []
        heappush, heappop = heapq.heappush, heapq.heappop

        def unpark(w: _Proc) -> None:
            for k in w.waits[0]:
                d = waiters.get(k)
                if d is not None:
                    d.pop(w, None)
            w.waits = None
            w.stamp += 1
            watch.pop(w, None)

        def reblock(p: _Proc, retry: float, eff: Any,
                    eager: bool) -> None:
            p.stamp += 1
            if retry is not INF:
                heappush(retry_heap, (retry, p.pos, p.stamp))
                if len(retry_heap) > compact_at:
                    compact()
            if p.teff is eff:
                keys = p.tkeys
            else:
                wake_keys: set = set()
                dirty_keys: set = set()
                _collect_triggers(ctx, p.inst, eff, wake_keys, dirty_keys)
                keys = p.tkeys = (wake_keys, tuple(dirty_keys))
                p.teff = eff
            p.waits = keys
            dirty_keys = keys[1]
            if dirty_keys:
                p.vsnap = [(k, vers.get(k, 0)) for k in dirty_keys]
                if eager:
                    watch[p] = None
            else:
                p.vsnap = None
            for k in keys[0]:
                ws = waiters.get(k)
                if ws is None:
                    ws = waiters[k] = {}
                ws[p] = None

        def compact() -> None:
            nonlocal compact_at
            retry_heap[:] = [e for e in retry_heap
                             if procs[e[1]].stamp == e[2]]
            heapq.heapify(retry_heap)
            compact_at = max(64, 8 * len(pairs), 2 * len(retry_heap))

        def vers_stale(p: _Proc) -> bool:
            snap = p.vsnap  # [(dirty_key, version)] or None
            if snap is None:
                return False
            for k, v in snap:
                if vers.get(k, 0) != v:
                    return True
            return False

        def refresh(p: _Proc) -> Optional[float]:
            """Recompute a parked proc's retry in place (issues and
            stores can only delay a retry, never grant readiness)."""
            t = p.time
            ctx.par_ready_req = False
            retry = _ready_ev(ctx, p.inst, p.effect,
                              t if t > floor else floor)
            eager = ctx.par_ready_req
            p.stamp += 1
            if retry is None:
                # cannot happen (issues/stores never grant readiness);
                # defensively schedule an immediate retry at local time
                retry = t if t > floor else floor
            if retry is not INF:
                heappush(retry_heap, (retry, p.pos, p.stamp))
            dirty_keys = p.waits[1]
            if dirty_keys:
                p.vsnap = [(k, vers.get(k, 0)) for k in dirty_keys]
                if eager:
                    watch[p] = None
                else:
                    watch.pop(p, None)
            else:
                p.vsnap = None
            return retry

        while live_count > 0:
            pass_no += 1
            if pass_no > max_steps:
                raise RuntimeError("simulation step limit exceeded")
            rot = pass_no - 1

            heap: List[Tuple[float, int, int]] = []  # (time, rotidx, pos)
            if to_pump:
                # generator pump order is pairs order, as in polling
                if len(to_pump) > 1:
                    to_pump.sort(key=_proc_pos)
                for p in to_pump:
                    try:
                        p.effect = p.gen.send(p.send)
                        p.send = None
                    except StopIteration:
                        p.done = True
                        live_count -= 1
                        continue
                    t = p.time
                    heap.append((t if t > floor else floor,
                                 (p.iidx - rot) % n_inst, p.pos))
                to_pump = []
            for p in next_cand:
                t = p.time
                heap.append((t if t > floor else floor,
                             (p.iidx - rot) % n_inst, p.pos))
            next_cand = []
            if live_count == 0:
                break
            if len(heap) > 1:
                heapq.heapify(heap)

            progressed = False
            while heap:
                key = heappop(heap)
                t = key[0]
                p = procs[key[2]]
                inst = p.inst
                eff = p.effect
                ctx.par_ready_req = False
                retry = _ready_ev(ctx, inst, eff, t)
                if retry is not None:
                    reblock(p, retry, eff, ctx.par_ready_req)
                    continue
                p.send = _exec_ev(ctx, inst, eff, t, ev)
                n_events += 1
                cls = eff.__class__
                if cls is Delay:
                    p.time = t + (eff.cycles if eff.cycles > 0 else 0)
                else:
                    p.time = t + p.proc.ii
                if cls is Halt:
                    p.done = True
                    live_count -= 1
                else:
                    to_pump.append(p)
                p.effect = None
                p.blocked_on = None
                progressed = True
                if ev:
                    for k in ev:
                        kind = k[0]
                        if kind == "push" or kind == "pop":
                            ws = waiters.get(k)
                            if not ws:
                                continue
                            for w in list(ws):
                                unpark(w)
                                wt = w.time
                                wkey = (wt if wt > floor else floor,
                                        (w.iidx - rot) % n_inst, w.pos)
                                if wkey > key:
                                    heappush(heap, wkey)
                                else:
                                    next_cand.append(w)
                        else:  # issue / mem / store: O(1) version bump
                            vers[k] = vers.get(k, 0) + 1
                    ev.clear()

            if not progressed:
                # no-progress pass.  A port issue or store can only
                # *delay* a parked proc's retry, never unblock it, so
                # retry refreshes were deferred to here, where the clock
                # jump consumes them: refresh any proc whose port-version
                # snapshot went stale, lazily, starting from the heap
                # minimum — fresh retries are >= stale ones, so the first
                # version-valid minimum is the true fresh minimum.
                for p in list(watch):
                    # non-monotone parks first (a Par with a Req sub that
                    # was ready when it parked): their fresh retry may
                    # undercut every cached heap entry
                    if vers_stale(p):
                        refresh(p)
                while retry_heap:
                    r, pos, stamp = retry_heap[0]
                    p = procs[pos]
                    if stamp != p.stamp:
                        heappop(retry_heap)
                        continue
                    if vers_stale(p):
                        heappop(retry_heap)
                        refresh(p)
                        continue
                    break
                if not retry_heap:
                    self._deadlock_event(
                        ctx, [ip for ip in pairs if not ip[1].done], floor)
                best = retry_heap[0][0]
                while retry_heap and retry_heap[0][0] == best:
                    _, pos, stamp = heappop(retry_heap)
                    p = procs[pos]
                    if stamp != p.stamp:
                        continue
                    if vers_stale(p):
                        # fresh retry is >= best; requeue — if it still
                        # lands exactly on the jump the next iteration
                        # pops it again (now version-valid) and wakes it
                        refresh(p)
                        continue
                    unpark(p)
                    next_cand.append(p)
                floor = best

        # p.time is materialized at every execution (and a finishing
        # StopIteration is discovered on the pass right after its proc's
        # last execution, before any jump), so _finalize's per-instance
        # cycle accounting needs no floor catch-up here
        return n_events, pass_no

    def _finalize(self, inst: _Inst) -> SimResult:
        counts: Dict[str, int] = {}
        for name, st in inst.chans.items():
            if st.fifo:
                raise ConservationError(
                    f"channel {name!r} finished with {len(st.fifo)} "
                    f"undrained entries"
                )
            if st.reqs != st.resps:
                raise ConservationError(
                    f"channel {name!r}: {st.reqs} requests but "
                    f"{st.resps} responses"
                )
            if st.enqs != st.deqs:
                raise ConservationError(
                    f"channel {name!r}: {st.enqs} enqs but {st.deqs} deqs"
                )
            counts[name] = st.reqs + st.enqs

        t_end = max(
            [p.time for p in inst.procs]
            + list(inst.port_last_store.values()) + [0.0]
        )
        # per-instance attribution: only the reads THIS tenant issued —
        # a shared model's global .reads counter would credit every
        # tenant with the whole port's traffic
        visible = dict(self.shared)
        visible.update(inst.private)
        return SimResult(
            cycles=int(round(t_end)),
            stores=inst.stores,
            counts=counts,
            mem_reads={port: inst.port_reads.get(port, 0)
                       for port in visible},
        )


def simulate(
    program: DaeProgram,
    memories: Dict[str, MemoryModel],
    max_steps: int = 500_000_000,
    tracer: Any = None,
    engine: str = "event",
) -> SimResult:
    """Run ``program`` against ``memories`` (one entry per port name).

    Single-instance wrapper over :class:`SharedMemoryEngine`; all ports
    are bound as shared (with one tenant there is nobody to share with,
    so the timing is identical to the legacy single-program scheduler).
    ``engine`` selects the scheduler implementation (``"event"`` or the
    legacy ``"polling"`` oracle); both are bit-exact.
    """
    eng = SharedMemoryEngine(
        [EngineInstance("", program)], memories,
        tracer=tracer, max_steps=max_steps, engine=engine)
    return eng.run().instances[0]
