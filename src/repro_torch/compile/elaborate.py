"""Pass 1 — elaborate: trace a DaeProgram into the dataflow IR.

The port's copy of ``repro.compile.elaborate``, unchanged but for imports.

The tracer is the same functional pump loop as
:meth:`repro_torch.core.dae.DaeProgram.validate_channels` (loads answered
immediately, capacities never block, ``Par``/``Fused`` handled
recursively), extended to *record* every request address, response
value, and store event.  It requires a rebuildable program (generator
factories, the PR-5 contract) because it pumps fresh instances — the
caller's program is left untouched and can still be simulated.

Classification needs two runs: the second runs against *perturbed*
memories (every numeric element shifted by +1 — order-preserving, so
comparison-driven control flow keeps terminating) and streams are
compared across runs — identical address streams are STATIC, streams
tracking another channel's responses are INDIRECT, the rest DEPENDENT.
The perturbed run serves loads modulo the port length (a shifted
address may walk off the end; the *recorded* address stays raw so
INDIRECT matching sees the true dataflow) and is step-capped; if it
fails anyway, every stream conservatively degrades to DEPENDENT.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.dae import (ConservationError, DaeProgram, Deq, Enq, Halt,
                            LoadChannel, Req, Resp, Store)
from repro_torch.compile.ir import (ChannelIR, DaeIR, PortArray, StoreIR,
                              StreamKind)

__all__ = ["elaborate", "ElaborationError"]


class ElaborationError(ConservationError):
    """The functional trace could not complete (stall, overrun, bad
    index) — the program cannot be staged."""


@dataclasses.dataclass
class _Trace:
    addrs: Dict[str, List[int]]
    values: Dict[str, List[Any]]
    stores: List[Tuple[str, int, Any]]
    channels: Dict[str, Any]              # name -> Channel object


def _perturb_value(v: Any) -> Any:
    if isinstance(v, bool) or v is None:
        return v
    if isinstance(v, (int, np.integer)):
        return v + 1
    if isinstance(v, (float, np.floating)):
        return v + 1.0
    if isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.number):
        return v + 1
    return v


def _perturb(memories: Dict[str, Any]) -> Dict[str, Any]:
    return {port: [_perturb_value(v) for v in data]
            for port, data in memories.items()}


def _run_trace(prog: DaeProgram, memories: Dict[str, Any], *,
               modulo: bool, max_steps: int) -> _Trace:
    """One recording dry run.  ``modulo`` wraps load addresses into the
    port's range (the perturbed run only — shifted pointers may walk
    out of bounds without that meaning anything about the original)."""
    from repro_torch.core.simulator import Fused, Par  # deferred: no cycle

    tr = _Trace({}, {}, [], {})
    fifos: Dict[str, List[Any]] = {}

    def serve(port: str, addr: int) -> Any:
        data = memories.get(port)
        if data is None:
            return 0
        n = len(data)
        if modulo:
            if n == 0:
                return 0
            return data[int(addr) % n]
        try:
            return data[addr]
        except (IndexError, KeyError, TypeError) as e:
            raise ElaborationError(
                f"{prog.name}: load from port {port!r} address {addr!r} "
                f"failed during elaboration: {e}")

    def ready(eff: Any) -> bool:
        if isinstance(eff, (Resp, Deq)):
            return bool(fifos.get(eff.channel.name))
        if isinstance(eff, Par):
            return all(ready(s) for s in eff.effects)
        if isinstance(eff, Fused):
            return ready(eff.first)
        return True

    def run(eff: Any) -> Any:
        if isinstance(eff, Req):
            ch = eff.channel
            tr.channels.setdefault(ch.name, ch)
            addr = int(eff.addr)
            value = serve(ch.port, eff.addr)
            tr.addrs.setdefault(ch.name, []).append(addr)
            tr.values.setdefault(ch.name, []).append(value)
            fifos.setdefault(ch.name, []).append(value)
            return None
        if isinstance(eff, (Resp, Deq)):
            tr.channels.setdefault(eff.channel.name, eff.channel)
            return fifos[eff.channel.name].pop(0)
        if isinstance(eff, Enq):
            tr.channels.setdefault(eff.channel.name, eff.channel)
            fifos.setdefault(eff.channel.name, []).append(eff.value)
            return None
        if isinstance(eff, Store):
            tr.stores.append((eff.port, int(eff.addr), eff.value))
            return None
        if isinstance(eff, Par):
            return tuple(run(s) for s in eff.effects)
        if isinstance(eff, Fused):
            value = run(eff.first)
            follow = eff.then(value)
            if follow is not None:
                if not ready(follow):
                    raise ElaborationError(
                        f"{prog.name}: Fused follow-up {follow!r} would "
                        f"block during elaboration")
                run(follow)
            return value
        return None  # Delay / StoreWait / Halt

    gens = [(p.name, p.factory()) for p in prog.processes]
    steps = 0

    def advance(i: int, send: Any) -> Any:
        nonlocal steps
        steps += 1
        if steps > max_steps:
            raise ElaborationError(
                f"{prog.name}: elaboration exceeded {max_steps} steps")
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
            raise ElaborationError(
                f"{prog.name}: elaboration stalled "
                f"(processes {stuck} blocked on empty channels)")
    return tr


# ---------------------------------------------------------------------------
# Stream classification + store matching (run A vs run B)
# ---------------------------------------------------------------------------


def _veq(a: Any, b: Any) -> bool:
    try:
        return bool(np.array_equal(a, b))
    except Exception:
        return a is b


def _as_int(v: Any) -> Optional[int]:
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, np.integer)):
        return int(v)
    return None


def _classify(load_names: List[str], a: _Trace, b: _Trace
              ) -> Dict[str, Tuple[StreamKind, Optional[str], int]]:
    out: Dict[str, Tuple[StreamKind, Optional[str], int]] = {}
    for name in load_names:
        aa = a.addrs.get(name, [])
        ab = b.addrs.get(name, [])
        if len(aa) == len(ab) and aa == ab:
            out[name] = (StreamKind.STATIC, None, 0)
            continue
        # one-hop indirect: addr k tracks channel s's response k (+const)
        found = None
        for s in load_names:
            if s == name:
                continue
            va = [_as_int(v) for v in a.values.get(s, [])]
            vb = [_as_int(v) for v in b.values.get(s, [])]
            if (len(va) != len(aa) or len(vb) != len(ab)
                    or len(aa) != len(ab) or not aa
                    or any(v is None for v in va)
                    or any(v is None for v in vb)):
                continue
            off = aa[0] - va[0]
            if (all(aa[k] == va[k] + off for k in range(len(aa)))
                    and all(ab[k] == vb[k] + off for k in range(len(ab)))):
                found = (s, off)
                break
        if found is not None:
            out[name] = (StreamKind.INDIRECT, found[0], found[1])
        else:
            out[name] = (StreamKind.DEPENDENT, None, 0)
    return out


def _match_stores(load_names: List[str], a: _Trace, b: _Trace,
                  notes: List[str]) -> List[StoreIR]:
    stores = [StoreIR(port=p, addr=ad, value=v) for p, ad, v in a.stores]
    same_shape = (len(a.stores) == len(b.stores) and all(
        sa[0] == sb[0] and sa[1] == sb[1]
        for sa, sb in zip(a.stores, b.stores)))
    if not same_shape:
        notes.append("store sequence diverged under perturbation; "
                     "no copy/const matching (chase-spec only)")
        return stores
    used: Dict[str, set] = {n: set() for n in load_names}
    for t, st in enumerate(stores):
        va, vb = a.stores[t][2], b.stores[t][2]
        hit = None
        for c in load_names:
            ca, cb = a.values.get(c, []), b.values.get(c, [])
            if len(ca) != len(cb):
                continue
            idxs = [k for k in range(len(ca))
                    if _veq(ca[k], va) and _veq(cb[k], vb)]
            if not idxs:
                continue
            free = [k for k in idxs if k not in used[c]]
            hit = (c, (free or idxs)[0])
            break
        if hit is not None:
            used[hit[0]].add(hit[1])
            st.source = hit
        elif _veq(va, vb):
            st.const = True
    return stores


# ---------------------------------------------------------------------------
# Port staging
# ---------------------------------------------------------------------------


def _stage_port(name: str, data: Any, notes: List[str]
                ) -> Optional[PortArray]:
    rows = []
    width = None
    is_float = False
    for v in data:
        if v is None:
            rows.append(None)
            continue
        if isinstance(v, np.ndarray):
            row = np.atleast_1d(v)
        elif isinstance(v, (bool, str)):
            notes.append(f"port {name!r}: non-numeric element {v!r}; "
                         f"port not staged")
            return None
        elif isinstance(v, (int, np.integer)):
            row = np.array([int(v)])
        elif isinstance(v, (float, np.floating)):
            row = np.array([float(v)])
            is_float = True
        else:
            notes.append(f"port {name!r}: unstageable element type "
                         f"{type(v).__name__}")
            return None
        if np.issubdtype(row.dtype, np.floating):
            is_float = True
        elif not np.issubdtype(row.dtype, np.integer):
            notes.append(f"port {name!r}: non-numeric dtype {row.dtype}")
            return None
        if width is None:
            width = len(row)
        elif width != len(row):
            notes.append(f"port {name!r}: ragged rows ({width} vs "
                         f"{len(row)}); port not staged")
            return None
        rows.append(row)
    width = width or 1
    dtype = np.float32 if is_float else np.int32
    arr = np.zeros((len(rows), width), dtype)
    for i, row in enumerate(rows):
        if row is not None:
            arr[i] = row.astype(dtype)
    return PortArray(name, arr)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def elaborate(prog: DaeProgram, memories: Dict[str, Any], *,
              max_steps: int = 1_000_000) -> DaeIR:
    """Trace ``prog`` (twice) into a :class:`DaeIR`.

    ``memories`` maps port name -> indexable data, exactly as
    :meth:`DaeProgram.validate_channels` takes it.  Raises
    :class:`ElaborationError` if the true-memory trace cannot complete;
    a failing *perturbed* trace only degrades classification.
    """
    if not prog.rebuildable:
        bad = [p.name for p in prog.processes if not p.rebuildable]
        raise ElaborationError(
            f"{prog.name}: processes {bad} were built from live "
            f"generators; elaboration stages fresh instances — pass the "
            f"generator function itself to Process")

    notes: List[str] = []
    tr_a = _run_trace(prog, memories, modulo=False, max_steps=max_steps)

    perturbed_ok = True
    try:
        tr_b = _run_trace(prog, _perturb(memories), modulo=True,
                          max_steps=max_steps)
    except ElaborationError as e:
        perturbed_ok = False
        tr_b = tr_a
        notes.append(f"perturbed run failed ({e}); every stream "
                     f"conservatively DEPENDENT")

    load_names = [n for n, ch in tr_a.channels.items()
                  if isinstance(ch, LoadChannel)]

    if perturbed_ok:
        kinds = _classify(load_names, tr_a, tr_b)
        stores = _match_stores(load_names, tr_a, tr_b, notes)
    else:
        kinds = {n: (StreamKind.DEPENDENT, None, 0) for n in load_names}
        stores = [StoreIR(port=p, addr=ad, value=v)
                  for p, ad, v in tr_a.stores]

    channels = {}
    for name in load_names:
        ch = tr_a.channels[name]
        kind, source, offset = kinds[name]
        channels[name] = ChannelIR(
            name=name, port=ch.port, capacity=ch.capacity,
            addrs=tr_a.addrs.get(name, []),
            values=tr_a.values.get(name, []),
            kind=kind, source=source, offset=offset)

    stream_only = [n for n, ch in tr_a.channels.items()
                   if not isinstance(ch, LoadChannel)]
    if stream_only:
        notes.append(f"stream channels {stream_only} elaborated away "
                     f"(internal plumbing; values flow through the trace)")

    ports = {}
    for pname, data in memories.items():
        staged = _stage_port(pname, data, notes)
        if staged is not None:
            ports[pname] = staged

    return DaeIR(name=prog.name, channels=channels, stores=stores,
                 ports=ports, raw_memories=dict(memories),
                 perturbed_ok=perturbed_ok, notes=notes)
