"""Run a whole benchmark axis: every registered cell, in order (the
port of ``repro.bench.matrix``).

The runner is deliberately boring — no cell selection, no skips, no
retries.  The SPEC discipline (SNIPPETS.md §1) is that a suite either
runs completely or not at all: cherry-picking cells is how a benchmark
file silently stops covering what its baseline pins.  Anything a cell
needs to vary (problem scale, seeds) comes through
:class:`~repro_torch.bench.registry.BenchContext`, so the report's metadata
fully determines the run.

An unexpected exception from a cell aborts the axis: benchmarks are
load-bearing tests here, and a half-written BENCH file that a later
diff would read as "cells removed" is worse than a loud failure.
Expected deadlocks are *results* (``status="deadlock"``), not
exceptions — cells that sweep into the §5.3 regime catch
:class:`~repro_torch.core.simulator.DeadlockError` themselves.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.bench.registry import (BenchContext, Cell, CellResult,
                                  check_cells)
from repro_torch.bench.report import (bench_path, build_report, cell_csv,
                                write_report)

__all__ = ["run_axis", "run_cells"]


def run_cells(cells: List[Cell], ctx: BenchContext,
              csv_print: Optional[Callable[[str], None]] = None,
              ) -> List[Tuple[Cell, CellResult]]:
    """Execute every cell, streaming legacy CSV rows as results land."""
    results: List[Tuple[Cell, CellResult]] = []
    for cell in cells:
        result = cell.run(ctx)
        if not isinstance(result, CellResult):
            raise TypeError(f"cell {cell.name!r} returned "
                            f"{type(result).__name__}, expected CellResult")
        results.append((cell, result))
        if csv_print is not None:
            csv_print(cell_csv(cell, result))
    return results


def run_axis(axis: str, cells: List[Cell], ctx: BenchContext, *,
             out_dir: Path,
             csv_print: Optional[Callable[[str], None]] = None) -> Dict:
    """Run one axis end-to-end and write its ``BENCH_<axis>.json``.

    Returns the (schema-validated) report dict; the file lands at
    ``out_dir/BENCH_<axis>.json``.
    """
    check_cells(cells, axis)
    results = run_cells(cells, ctx, csv_print)
    report = build_report(axis, results, smoke=ctx.smoke, seed=ctx.seed)
    path = write_report(report, bench_path(axis, out_dir))
    if csv_print is not None:
        csv_print(f"matrix/{axis}/bench_json,0,path={path.name};"
                  f"cells={len(cells)}")
    return report
