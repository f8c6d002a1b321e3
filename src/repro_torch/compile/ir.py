"""The compiler's dataflow IR — what `elaborate` extracts from a program.

The port's copy of ``repro.compile.ir``.

A :class:`DaeIR` is the *staged* view of one :class:`~repro_torch.core.dae.
DaeProgram` instance: per-channel request address streams, per-store
(port, addr, value) events, and the port data snapshots, all recorded by
a functional dry run (the same pump loop as
:meth:`~repro_torch.core.dae.DaeProgram.validate_channels`).

Staging semantics (the honest part, documented in docs/compiler.md):
like a JAX trace, elaboration specializes the program on its concrete
inputs.  Control flow that depends on *loaded values* therefore bakes
into the trace — so every stream is classified by a second, perturbed
elaboration run:

  * ``STATIC``    — the address stream is identical under perturbed
    memory contents: addresses are control metadata (loop indices,
    closure data), legal to scalar-prefetch.
  * ``INDIRECT``  — address ``k`` equals channel *s*'s response ``k``
    (plus a constant offset) under both runs: a one-hop dependent load
    (``a[b[i]]``), compiled as a two-phase ring.
  * ``DEPENDENT`` — anything else: a genuine pointer chase whose
    addresses are functions of loaded values.  Compilable only with a
    :class:`ChaseSpec` carrying the loop's semantics in traceable form.

Stores are matched the same way: a store whose value equals some
channel's response ``k`` under both runs is a *copy* (the decoupled
execute loop is a data mover — the common case for every paper
benchmark's inner loop); a store whose value is run-invariant but
matches no response is a *constant* (data-independent compute, partially
evaluated at compile time); anything else is unexplained and needs a
:class:`ChaseSpec` (or is rejected by the check pass).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class StreamKind(enum.Enum):
    STATIC = "static"
    INDIRECT = "indirect"
    DEPENDENT = "dependent"


@dataclasses.dataclass
class ChannelIR:
    """One load channel's traced request stream (true-memory run)."""

    name: str
    port: str
    capacity: int
    addrs: List[int]                      # request addresses, issue order
    values: List[Any]                     # matching responses (run A)
    kind: StreamKind = StreamKind.DEPENDENT
    source: Optional[str] = None          # INDIRECT: feeding channel
    offset: int = 0                       # INDIRECT: addr = source_resp + offset

    @property
    def count(self) -> int:
        return len(self.addrs)


@dataclasses.dataclass
class StoreIR:
    """One traced store event, in program store order.

    ``source`` is the (channel, response index) whose value this store
    copies (both runs agree); ``const`` marks a run-invariant value with
    no response source.  A store that is neither is *unexplained* — the
    check pass rejects it unless a :class:`ChaseSpec` accounts for it.
    """

    port: str
    addr: int
    value: Any
    source: Optional[Tuple[str, int]] = None
    const: bool = False

    @property
    def explained(self) -> bool:
        return self.const or self.source is not None


@dataclasses.dataclass
class ChaseSpec:
    """Declarative semantics of a dependent-load loop, in traceable form.

    This is what a workload author supplies *instead of a kernel* when
    the access stream is a genuine pointer chase (kind ``DEPENDENT``):
    the chase's state machine as traceable callables, mirroring the
    ``init_state``/``step`` closures the simulator program itself is
    built from (see ``_binsearch_phases`` in :mod:`repro_torch.core.workloads`
    and the binsearch target in :mod:`repro_torch.compile.targets`).

    * ``state0``     — (M, S) int32 initial state, one row per item;
    * ``addr_fn(state) -> addr``   — the next request address;
    * ``step_fn(state, row) -> state`` — consume one loaded row
      (``row`` is the (W,) int32 port row at ``addr``); must be
      *lock-step safe*: running exactly ``max_steps`` iterations with
      redundant tail loads reproduces the early-exit results (Listing
      5's fixed-length trick — the repo's ``fixed_step`` closures are
      already written this way);
    * ``out_fn(state) -> (addr, value)`` — the final store per item.

    ``state`` is passed as a tuple of S int32 scalars.  All three
    callables must be traceable by :mod:`repro_torch.compile.chase`
    (Python operators and its ``where``/``minimum``/``maximum``/``clip``:
    the CUDA kernel runs them as a traced register program), valid on
    torch int32 tensors (the kernel's plain version) *and* on plain numpy
    ints (the check pass verifies the spec reproduces the simulator's
    stores before codegen trusts it).
    """

    port: str
    state0: np.ndarray
    max_steps: int
    addr_fn: Callable[[Tuple[Any, ...]], Any]
    step_fn: Callable[[Tuple[Any, ...], Any], Tuple[Any, ...]]
    out_fn: Callable[[Tuple[Any, ...]], Tuple[Any, Any]]
    out_port: str = "out"

    @property
    def n_items(self) -> int:
        return int(self.state0.shape[0])

    @property
    def state_width(self) -> int:
        return int(self.state0.shape[1])


@dataclasses.dataclass
class PortArray:
    """One memory port's data, staged as a dense (N, W) array.

    Scalars become width-1 rows; 1-D ndarray elements become width-W
    rows (the decoupled row fetch).  ``None`` entries (uninitialized
    output slots) are zero-filled.
    """

    name: str
    array: np.ndarray       # (N, W)

    @property
    def n(self) -> int:
        return int(self.array.shape[0])

    @property
    def width(self) -> int:
        return int(self.array.shape[1])


@dataclasses.dataclass
class DaeIR:
    """The elaborated program: streams + stores + staged port data."""

    name: str
    channels: Dict[str, ChannelIR]
    stores: List[StoreIR]
    ports: Dict[str, PortArray]
    raw_memories: Dict[str, Any]
    perturbed_ok: bool                    # the classification run finished
    notes: List[str] = dataclasses.field(default_factory=list)

    def channels_of_kind(self, kind: StreamKind) -> List[ChannelIR]:
        return [c for c in self.channels.values() if c.kind is kind]

    def describe(self) -> str:
        lines = [f"DaeIR({self.name})"]
        for c in self.channels.values():
            src = f" <- {c.source}+{c.offset}" if c.source else ""
            lines.append(f"  channel {c.name}: port={c.port} "
                         f"count={c.count} {c.kind.value}{src}")
        n_copy = sum(1 for s in self.stores if s.source is not None)
        n_const = sum(1 for s in self.stores if s.const)
        n_open = sum(1 for s in self.stores if not s.explained)
        lines.append(f"  stores: {len(self.stores)} "
                     f"(copy={n_copy} const={n_const} unexplained={n_open})")
        for n in self.notes:
            lines.append(f"  note: {n}")
        return "\n".join(lines)
