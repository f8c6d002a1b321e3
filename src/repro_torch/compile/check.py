"""Pass 3 — check: validate capacity/deadlock and expressibility.

The port's copy of ``repro.compile.check``, unchanged but for imports.

Two layers:

* the program-level §5.3/§5.4 validation — the same
  :meth:`DaeProgram.validate_channels` dry run the simulator relies on
  (conflicting channel declarations, conservation, stalls);
* compiler-specific expressibility: can the classified IR actually be
  lowered onto the ring scaffolds?  Rejections raise
  :class:`CompileError` with *actionable* diagnostics — each one names
  the offending channel/store and says what would make the program
  compilable (usually: supply a :class:`~repro_torch.compile.ir.ChaseSpec`).

The check also picks the codegen shape:

  ``gather``  every stream STATIC, every store a copy/const;
  ``deref``   as above plus one-hop INDIRECT streams (two-phase rings);
  ``chase``   a :class:`ChaseSpec` was supplied: exactly one load
              channel, and the spec must *reproduce the simulator's
              stores* in a numpy pre-run before codegen trusts it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.dae import ConservationError, DaeProgram
from repro_torch.compile.ir import ChaseSpec, DaeIR, StreamKind

__all__ = ["CompileError", "CheckResult", "check"]


class CompileError(ValueError):
    """A program the compiler cannot (or must not) lower.

    ``pass_name`` says which pass rejected it; ``diagnostics`` is a list
    of per-finding messages, each naming the construct at fault.
    """

    def __init__(self, pass_name: str, diagnostics: List[str]):
        self.pass_name = pass_name
        self.diagnostics = list(diagnostics)
        lines = "\n".join(f"  - {d}" for d in self.diagnostics)
        super().__init__(f"[{pass_name}] program not compilable:\n{lines}")


@dataclasses.dataclass
class CheckResult:
    shape: str                                    # 'gather'|'deref'|'chase'
    # out port -> (length, width, dtype)
    out_specs: Dict[str, Tuple[int, int, Any]]
    notes: List[str]


def _norm_value(v: Any) -> Optional[np.ndarray]:
    """A store value as a 1-D numeric row, or None if non-numeric."""
    if v is None or isinstance(v, (bool, str)):
        return None
    if isinstance(v, np.ndarray):
        row = np.atleast_1d(v)
    elif isinstance(v, (int, np.integer)):
        row = np.array([int(v)])
    elif isinstance(v, (float, np.floating)):
        row = np.array([float(v)], dtype=np.float64)
    else:
        return None
    if not np.issubdtype(row.dtype, np.number):
        return None
    return row


def _out_specs(ir: DaeIR, diags: List[str]) -> Dict[str, Tuple[int, int, Any]]:
    specs: Dict[str, Tuple[int, int, Any]] = {}
    per_port: Dict[str, List] = {}
    for st in ir.stores:
        per_port.setdefault(st.port, []).append(st)
    read_ports = {c.port for c in ir.channels.values()}
    for port, sts in per_port.items():
        if port in read_ports:
            diags.append(
                f"store port {port!r} is also a load port: read-after-"
                f"write through memory is not expressible in one kernel "
                f"pass — split the program or store to a separate port")
            continue
        width = None
        dtype = np.int32
        for st in sts:
            row = _norm_value(st.value)
            if row is None:
                diags.append(
                    f"store to {port!r}[{st.addr}] carries a non-numeric "
                    f"value {st.value!r}; only int/float scalars or 1-D "
                    f"numeric rows can be staged")
                width = None
                break
            if np.issubdtype(row.dtype, np.floating):
                dtype = np.float32
            if width is None:
                width = len(row)
            elif width != len(row):
                diags.append(
                    f"store port {port!r} mixes value widths ({width} vs "
                    f"{len(row)}): one dense output array per port needs "
                    f"a single row shape")
                width = None
                break
        if width is None:
            continue
        raw = ir.raw_memories.get(port)
        length = len(raw) if raw is not None else \
            max(st.addr for st in sts) + 1
        bad = [st.addr for st in sts if not (0 <= st.addr < length)]
        if bad:
            diags.append(f"store port {port!r}: addresses {bad[:4]} fall "
                         f"outside the declared extent {length}")
            continue
        specs[port] = (length, width, dtype)
    return specs


def _check_ring_shapes(ir: DaeIR, diags: List[str]) -> str:
    """Expressibility of the spec-free shapes; returns 'gather'/'deref'."""
    has_indirect = False
    static_names = {c.name for c in ir.channels_of_kind(StreamKind.STATIC)}
    for c in ir.channels.values():
        port = ir.ports.get(c.port)
        if port is None:
            diags.append(
                f"channel {c.name!r} loads from port {c.port!r} which "
                f"could not be staged as a dense array (see elaborate "
                f"notes); provide numeric, rectangular port data")
            continue
        if any(a < 0 for a in c.addrs):
            diags.append(
                f"channel {c.name!r} issues negative addresses (Python "
                f"end-relative indexing); the kernel address space is "
                f"[0, N) — rebase the address stream")
            continue
        if c.kind is StreamKind.DEPENDENT:
            diags.append(
                f"channel {c.name!r} ({c.count} requests on port "
                f"{c.port!r}) has a DEPENDENT address stream — addresses "
                f"are functions of loaded values beyond one indirection. "
                f"Supply a ChaseSpec (compile_program(..., chase=...)) "
                f"carrying the chase semantics, as the binsearch target "
                f"does")
            continue
        if c.kind is StreamKind.INDIRECT:
            has_indirect = True
            src = ir.channels.get(c.source or "")
            if src is None or src.name not in static_names:
                diags.append(
                    f"channel {c.name!r} is INDIRECT through "
                    f"{c.source!r}, which is not itself STATIC — only "
                    f"one level of indirection lowers to the two-phase "
                    f"ring; deeper chains need a ChaseSpec")
                continue
            sport = ir.ports.get(src.port)
            if sport is None or sport.width != 1 or \
                    not np.issubdtype(sport.array.dtype, np.integer):
                diags.append(
                    f"channel {c.name!r} derives addresses from port "
                    f"{src.port!r} rows, which are not scalar integers")
                continue
            nb = port.n
            bad = [a for a in c.addrs if not (0 <= a < nb)]
            if bad:
                diags.append(
                    f"channel {c.name!r}: derived addresses {bad[:4]} "
                    f"fall outside port {c.port!r} (extent {nb}); the "
                    f"ring clips addresses, which would silently change "
                    f"semantics — add an in-range sentinel row instead")
    return "deref" if has_indirect else "gather"


def _check_copy_staging(ir: DaeIR, diags: List[str]) -> None:
    """Traced response values must survive the float32/int32 staging
    cast — otherwise the kernel's copies differ from the trace."""
    for c in ir.channels.values():
        port = ir.ports.get(c.port)
        if port is None or not c.addrs:
            continue
        got = port.array[np.asarray(c.addrs)]
        want = np.stack([np.atleast_1d(np.asarray(v)) for v in c.values])
        if not np.array_equal(got.astype(np.float64),
                              want.astype(np.float64)):
            diags.append(
                f"channel {c.name!r}: port {c.port!r} data does not "
                f"survive the {port.array.dtype} staging cast "
                f"(values overflow or lose precision)")


def _check_stores_explained(ir: DaeIR, diags: List[str]) -> None:
    open_stores = [s for s in ir.stores if not s.explained]
    if open_stores:
        ex = open_stores[0]
        diags.append(
            f"{len(open_stores)} store(s) (first: {ex.port!r}[{ex.addr}] "
            f"= {ex.value!r}) are neither copies of a channel response "
            f"nor run-invariant constants — the execute loop computes on "
            f"loaded values.  Supply a ChaseSpec with the loop semantics "
            f"(out_fn), or restructure the program as a data mover")


def _verify_chase(ir: DaeIR, spec: ChaseSpec, diags: List[str],
                  budget: int = 500_000) -> None:
    """Numpy pre-run: the spec must reproduce the traced stores'
    final-state effect before codegen is allowed to trust it."""
    port = ir.ports.get(spec.port)
    if port is None:
        diags.append(f"ChaseSpec walks port {spec.port!r}, which was not "
                     f"staged")
        return
    if not np.issubdtype(port.array.dtype, np.integer):
        diags.append(f"ChaseSpec port {spec.port!r} is "
                     f"{port.array.dtype}; the chase kernel state is "
                     f"int32 — integer port data only")
        return
    if np.abs(spec.state0).max(initial=0) > np.iinfo(np.int32).max:
        diags.append("ChaseSpec state0 does not fit int32")
        return
    off_spec = [s for s in ir.stores if s.port != spec.out_port]
    if off_spec:
        diags.append(
            f"stores on ports {sorted({s.port for s in off_spec})!r} are "
            f"not covered by the ChaseSpec (out_port={spec.out_port!r})")
        return
    if spec.n_items * max(spec.max_steps, 1) > budget:
        ir.notes.append(
            f"chase-spec verification skipped: {spec.n_items} items x "
            f"{spec.max_steps} steps exceeds the {budget}-op check "
            f"budget; codegen proceeds on the author's contract")
        return

    n = port.n
    arr = port.array
    got: Dict[int, int] = {}
    for i in range(spec.n_items):
        state = tuple(int(x) for x in spec.state0[i])
        for _ in range(spec.max_steps):
            addr = int(spec.addr_fn(state))
            row = arr[min(max(addr, 0), n - 1)]
            state = tuple(int(x) for x in spec.step_fn(state, row))
        oa, ov = spec.out_fn(state)
        got[int(oa)] = int(ov)

    want: Dict[int, int] = {}
    for s in ir.stores:
        row = _norm_value(s.value)
        if row is None or len(row) != 1:
            diags.append(f"traced store {s.port!r}[{s.addr}] = "
                         f"{s.value!r} is not a scalar; the chase kernel "
                         f"emits one int32 per item")
            return
        want[s.addr] = int(row[0])
    if got != want:
        wrong = [a for a in sorted(set(got) | set(want))
                 if got.get(a) != want.get(a)][:4]
        detail = ", ".join(
            f"[{a}] spec={got.get(a)!r} sim={want.get(a)!r}" for a in wrong)
        diags.append(
            f"ChaseSpec does not reproduce the simulator's stores on "
            f"{spec.out_port!r} ({len(want)} traced): first mismatches "
            f"{detail}.  The spec's lock-step fixed_step must agree with "
            f"the program's early-exit results (see docs/compiler.md)")


def check(prog: DaeProgram, ir: DaeIR, *,
          chase: Optional[ChaseSpec] = None) -> CheckResult:
    """Validate ``prog``/``ir`` and pick the codegen shape, or raise
    :class:`CompileError` with one diagnostic per finding."""
    diags: List[str] = []
    notes: List[str] = []

    # program-level §5.3/§5.4 validation (conflicts, conservation)
    try:
        prog.validate_channels(ir.raw_memories)
    except (ValueError, ConservationError) as e:
        raise CompileError("check", [f"validate_channels rejected the "
                                     f"program: {e}"])

    if chase is not None:
        if len(ir.channels) != 1:
            diags.append(
                f"a ChaseSpec lowers exactly one load channel; the "
                f"program has {sorted(ir.channels)} — split multi-"
                f"channel chases into separate programs")
        else:
            (c,) = ir.channels.values()
            if c.port != chase.port:
                diags.append(
                    f"ChaseSpec walks port {chase.port!r} but channel "
                    f"{c.name!r} loads from {c.port!r}")
        _verify_chase(ir, chase, diags)
        if diags:
            raise CompileError("check", diags)
        length = max(len(ir.raw_memories.get(chase.out_port, []) or ()),
                     max((s.addr for s in ir.stores), default=-1) + 1)
        out_specs = {chase.out_port: (length, 1, np.int32)}
        return CheckResult("chase", out_specs, notes)

    shape = _check_ring_shapes(ir, diags)
    _check_stores_explained(ir, diags)
    _check_copy_staging(ir, diags)
    out_specs = _out_specs(ir, diags)
    if diags:
        raise CompileError("check", diags)
    if not ir.perturbed_ok:
        # classification degraded; _check_ring_shapes already rejected
        # every stream as DEPENDENT, so reaching here means no channels
        notes.append("perturbed elaboration failed; compiled with no "
                     "load channels")
    return CheckResult(shape, out_specs, notes)
