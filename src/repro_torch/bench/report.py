"""Assemble, persist and load ``BENCH_<axis>.json`` reports (the port
of ``repro.bench.report``).

A report is self-describing: besides the cells it records the git SHA
it ran at, the backend (``backend_tag`` of the default device:
``cuda:sm90`` on an H100, ``torch:cpu`` without a card), the RNG seed
and the Python version, so a
number in a months-old artifact can be traced to the exact tree and
environment that produced it.  Metadata lookups are tolerant — a
tarball checkout without git still benches, it just records
``git_sha: "unknown"``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

from repro_torch.bench.registry import Cell, CellResult
from repro_torch.bench.schema import SCHEMA_VERSION, validate_report

__all__ = ["bench_meta", "build_report", "bench_path", "write_report",
           "load_report", "cell_csv"]


def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=Path(__file__).resolve().parent)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except OSError:
        return "unknown"


def _backend() -> str:
    # lazy: diff-only consumers of repro_torch.bench load no kernel layer
    from repro_torch.kernels.common import backend_tag
    return backend_tag(torch.device(
        "cuda" if torch.cuda.is_available() else "cpu"))


def bench_meta(*, seed: int) -> Dict[str, object]:
    return {
        "git_sha": _git_sha(),
        "backend": _backend(),
        "seed": int(seed),
        "python": sys.version.split()[0],
    }


def build_report(axis: str, results: Iterable[Tuple[Cell, CellResult]],
                 *, smoke: bool, seed: int) -> Dict:
    """One schema-valid report for a fully-run axis."""
    cells: List[Dict] = []
    for cell, result in results:
        row = {"name": cell.name, "group": cell.group,
               "coords": dict(cell.coords)}
        row.update(result.to_json())
        cells.append(row)
    report = {
        "schema": SCHEMA_VERSION,
        "axis": axis,
        "smoke": bool(smoke),
        "meta": bench_meta(seed=seed),
        "cells": cells,
    }
    return validate_report(report)


def bench_path(axis: str, directory: Path) -> Path:
    return Path(directory) / f"BENCH_{axis}.json"


def write_report(report: Dict, path: Path) -> Path:
    validate_report(report)
    path = Path(path)
    path.write_text(json.dumps(report, indent=1, sort_keys=True) + "\n")
    return path


def load_report(path: Path) -> Dict:
    """Parse + validate; the diff gate must not compare malformed files."""
    with open(path) as f:
        return validate_report(json.load(f))


def cell_csv(cell: Cell, result: CellResult) -> str:
    """Legacy ``name,us_per_call,derived`` CSV row for ``benchmarks.run``.

    ``us_per_call`` is the *warm* time (0 for cycle-only cells) — the
    cold/warm split lives in the JSON; the CSV stream keeps its
    historical three-column shape for eyeballing and grep.
    """
    us = result.us_warm or 0.0
    parts: List[str] = []
    if result.status != "ok":
        parts.append(f"status={result.status}")
    if result.cycles is not None:
        parts.append(f"cycles={result.cycles}")
    parts += [f"{k}={v}" for k, v in result.derived.items()]
    return f"{cell.name},{us:.0f},{';'.join(parts) or 'ok'}"
