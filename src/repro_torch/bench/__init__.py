"""repro_torch.bench — the port of ``repro.bench``: a declarative
benchmark matrix with a regression gate, plus the port's measurement
helpers.

  * :mod:`~repro_torch.bench.registry` — cells keyed by ``(workload,
    kind, engine, backend, tenants, tuned)`` plus a ``run(ctx)``
    closure;
  * :mod:`~repro_torch.bench.matrix` — runs **every** cell of an axis
    (no cherry-picking) and writes one ``BENCH_<axis>.json``;
  * :mod:`~repro_torch.bench.schema` — versioned structural validation
    of those files, the reference's schema v2 unchanged, so a report of
    either package validates under the other's;
  * :mod:`~repro_torch.bench.report` — assembly and provenance (git
    SHA, ``backend_tag``, seed, Python);
  * :mod:`~repro_torch.bench.timing` — the cold/warm wall-clock
    primitive, the serve loop's percentiles and the cold-L2 CUDA-event
    kernel timer;
  * :mod:`~repro_torch.bench.diffing` — the baseline diff: exact on
    cycle counts and integer derived values, percentage-banded on warm
    wall-clock, fnmatch allowlist for intentional changes;
  * :mod:`~repro_torch.bench.data` — seeded card-filling inputs.

``chip_smoke.py`` declares the port's serve cells and runs them through
:func:`run_axis`.
"""

from repro_torch.bench.data import binsearch_data
from repro_torch.bench.diffing import (FAIL_KINDS, Finding, diff_reports,
                                       parse_allowlist, regressions)
from repro_torch.bench.matrix import run_axis, run_cells
from repro_torch.bench.registry import (COORD_KEYS, KINDS, BenchContext,
                                        Cell, CellResult, check_cells, coords)
from repro_torch.bench.report import (bench_meta, bench_path, build_report,
                                      cell_csv, load_report, write_report)
from repro_torch.bench.schema import (SCHEMA_VERSION, SchemaError,
                                      schema_problems, validate_report)
from repro_torch.bench.timing import (ColdTimer, Timing, measure,
                                      percentile, percentiles)

__all__ = [
    "BenchContext", "Cell", "CellResult", "COORD_KEYS", "KINDS",
    "check_cells", "coords",
    "run_axis", "run_cells",
    "SCHEMA_VERSION", "SchemaError", "schema_problems", "validate_report",
    "Timing", "measure", "percentile", "percentiles",
    "FAIL_KINDS", "Finding", "diff_reports", "parse_allowlist",
    "regressions",
    "bench_meta", "bench_path", "build_report", "cell_csv", "load_report",
    "write_report",
    "ColdTimer", "binsearch_data",
]
