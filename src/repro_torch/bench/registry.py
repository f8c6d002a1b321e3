"""Declarative benchmark-cell registry (the port of
``repro.bench.registry``).

A *cell* is one point of the evaluation matrix the paper's §6 grid
implies: ``(workload, sim|kernel|compiled, engine, backend, tenants,
tuned?)``.  Benchmarks declare cells; the matrix runner
(:mod:`repro_torch.bench.matrix`) runs **every** cell of an axis — the SPEC
discipline of running whole suites, never cherry-picking — and the
schema (:mod:`repro_torch.bench.schema`) pins the result shape.

Cells are plain data plus a ``run(ctx)`` closure so benchmark modules
stay importable without executing anything: enumeration is free,
execution is explicit.  ``BenchContext`` carries the only two global
knobs (``smoke`` problem scale and the RNG ``seed``) so a cell can
never consult ambient state the report does not record.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "COORD_KEYS", "KINDS", "BenchContext", "Cell", "CellResult",
    "check_cells", "coords",
]

# the axis tuple every cell is keyed by, in canonical order
COORD_KEYS: Tuple[str, ...] = (
    "workload", "kind", "engine", "backend", "tenants", "tuned")
KINDS: Tuple[str, ...] = ("sim", "kernel", "compiled", "serve")


@dataclasses.dataclass(frozen=True)
class BenchContext:
    """Global knobs a cell may depend on; everything else is in-coords.

    ``smoke`` selects the CI-sized problem scale; ``seed`` feeds every
    RNG a cell constructs (and is recorded in the report metadata, so a
    run is reproducible from its JSON alone).
    """

    smoke: bool = False
    seed: int = 0

    @property
    def sim_scale(self) -> str:
        """Simulator dataset scale: CI runs small, full runs paper."""
        return "small" if self.smoke else "paper"


def coords(workload: str, kind: str, *, engine: str = "event",
           backend: str = "sim", tenants: int = 1,
           tuned: Optional[bool] = None) -> Dict[str, object]:
    """Build (and sanity-check) a cell's coordinate dict.

    ``engine`` is the scheduler for ``sim`` cells ("event"/"polling")
    and the execution path for kernel and serve cells, the port's
    ``kernel_mode`` ("kernel" through the CUDA kernels, "ref" through
    the plain PyTorch path); ``backend`` is "sim" for pure-simulator
    cells, else ``kernels.common.backend_tag`` of the device the cell
    ran on ("cuda:sm90" on an H100, "torch:cpu").  ``tuned`` is
    three-valued: ``True``/``False``
    for cells on either side of a tuned-vs-default pair, ``None`` where
    the axis does not apply.
    """
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} not in {KINDS}")
    if not workload:
        raise ValueError("workload must be non-empty")
    if tenants < 1:
        raise ValueError(f"tenants must be >= 1, got {tenants}")
    return {"workload": workload, "kind": kind, "engine": engine,
            "backend": backend, "tenants": int(tenants), "tuned": tuned}


@dataclasses.dataclass
class CellResult:
    """What one cell run produced.

    ``cycles`` is first-class (exact-diffed): simulator cycle counts
    are deterministic across machines, unlike wall-clock.  ``status``
    is "deadlock" for cells whose *expected* outcome is the §5.3
    deadlock (e.g. negative capacity slack); an unexpected deadlock
    should raise instead.  ``derived`` holds scalar side-channels —
    integer values are exact-diffed, floats and strings are
    informational.  ``replay`` optionally records how to re-run the
    cell (``run_workload`` kwargs) so the diff gate can dump a VCD
    waveform of a failing simulator cell.
    """

    status: str = "ok"                     # "ok" | "deadlock"
    cycles: Optional[int] = None
    us_cold: Optional[float] = None
    us_warm: Optional[float] = None
    derived: Dict[str, object] = dataclasses.field(default_factory=dict)
    replay: Optional[Dict[str, object]] = None

    def to_json(self) -> Dict[str, object]:
        out: Dict[str, object] = {"status": self.status,
                                  "cycles": self.cycles,
                                  "us_cold": None, "us_warm": None,
                                  "derived": dict(self.derived)}
        if self.us_cold is not None:
            out["us_cold"] = round(float(self.us_cold), 1)
        if self.us_warm is not None:
            out["us_warm"] = round(float(self.us_warm), 1)
        if self.replay is not None:
            out["replay"] = dict(self.replay)
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class Cell:
    """One declared matrix cell: identity + coordinates + how to run it.

    ``name`` is unique within its axis and stable across runs (it is
    the diff key); ``group`` is the legacy ``benchmarks.run`` selector
    the cell migrated from (table1, fig4, kernel-bench, ...), kept so
    the old per-table entry points keep working.
    """

    axis: str
    name: str
    coords: Dict[str, object]
    run: Callable[[BenchContext], CellResult]
    group: str = ""


def check_cells(cells: List[Cell], axis: str) -> None:
    """Reject duplicate names / mixed axes before a run starts."""
    seen: Dict[str, Cell] = {}
    for c in cells:
        if c.axis != axis:
            raise ValueError(f"cell {c.name!r} declares axis {c.axis!r}, "
                             f"expected {axis!r}")
        if c.name in seen:
            raise ValueError(f"duplicate cell name {c.name!r} on axis "
                             f"{axis!r}")
        seen[c.name] = c
        missing = [k for k in COORD_KEYS if k not in c.coords]
        if missing:
            raise ValueError(f"cell {c.name!r} coords missing {missing}")
