"""Versioned schema for ``BENCH_<axis>.json`` reports (the port of
``repro.bench.schema``: the same problems, worded the same, in the same
order, so a report from either package validates alike under both).

Hand-rolled structural validation (no jsonschema dependency in the
container): :func:`schema_problems` walks a report and returns every
violation as a human-readable path, :func:`validate_report` raises one
:class:`SchemaError` listing all of them.  Both the matrix writer and
the diff gate validate — a malformed baseline must fail the gate
loudly, not silently compare as "no overlapping cells".

Schema history:

  * **1** — the ad-hoc pre-matrix files (free-form ``rows`` with
    ``us_per_call`` that folded JIT into call time and packed cycle
    counts into a ``derived`` string).
  * **2** — this module: per-cell ``coords`` tuple, first-class
    ``cycles``, explicit ``us_cold``/``us_warm`` split, ``status`` for
    expected deadlocks, typed ``derived`` scalars, run metadata
    (git SHA, backend, seed) for provenance.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.bench.registry import COORD_KEYS, KINDS

__all__ = ["SCHEMA_VERSION", "SchemaError", "schema_problems",
           "validate_report"]

SCHEMA_VERSION = 2

_STATUSES = ("ok", "deadlock")
_SCALARS = (str, int, float, bool)


class SchemaError(ValueError):
    """A report violated the BENCH schema; ``problems`` lists every hit."""

    def __init__(self, problems: List[str]):
        self.problems = list(problems)
        super().__init__(
            "BENCH report failed schema validation:\n  "
            + "\n  ".join(self.problems))


def _is_num(v: object) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def schema_problems(report: object) -> List[str]:
    """Every schema violation in ``report`` (empty list == valid)."""
    p: List[str] = []
    if not isinstance(report, dict):
        return [f"report must be an object, got {type(report).__name__}"]
    if report.get("schema") != SCHEMA_VERSION:
        p.append(f"schema: expected {SCHEMA_VERSION}, "
                 f"got {report.get('schema')!r}")
    if not (isinstance(report.get("axis"), str) and report.get("axis")):
        p.append("axis: must be a non-empty string")
    if not isinstance(report.get("smoke"), bool):
        p.append("smoke: must be a bool")

    meta = report.get("meta")
    if not isinstance(meta, dict):
        p.append("meta: must be an object")
    else:
        for key in ("git_sha", "backend", "python"):
            if not isinstance(meta.get(key), str):
                p.append(f"meta.{key}: must be a string")
        if not isinstance(meta.get("seed"), int):
            p.append("meta.seed: must be an int")

    cells = report.get("cells")
    if not (isinstance(cells, list) and cells):
        p.append("cells: must be a non-empty list")
        return p
    seen: Dict[str, int] = {}
    for i, cell in enumerate(cells):
        where = f"cells[{i}]"
        if not isinstance(cell, dict):
            p.append(f"{where}: must be an object")
            continue
        name = cell.get("name")
        if not (isinstance(name, str) and name):
            p.append(f"{where}.name: must be a non-empty string")
        else:
            where = f"cells[{name}]"
            if name in seen:
                p.append(f"{where}: duplicate cell name")
            seen[name] = i
        if not isinstance(cell.get("group"), str):
            p.append(f"{where}.group: must be a string")
        p.extend(_coord_problems(cell.get("coords"), where))
        p.extend(_result_problems(cell, where))
    return p


def _coord_problems(coords: object, where: str) -> List[str]:
    p: List[str] = []
    if not isinstance(coords, dict):
        return [f"{where}.coords: must be an object"]
    extra = sorted(set(coords) - set(COORD_KEYS))
    missing = sorted(set(COORD_KEYS) - set(coords))
    if extra or missing:
        p.append(f"{where}.coords: keys must be exactly {COORD_KEYS} "
                 f"(missing={missing}, extra={extra})")
        return p
    for key in ("workload", "engine", "backend"):
        if not (isinstance(coords[key], str) and coords[key]):
            p.append(f"{where}.coords.{key}: must be a non-empty string")
    if coords["kind"] not in KINDS:
        p.append(f"{where}.coords.kind: {coords['kind']!r} not in {KINDS}")
    tenants = coords["tenants"]
    if not (isinstance(tenants, int) and not isinstance(tenants, bool)
            and tenants >= 1):
        p.append(f"{where}.coords.tenants: must be an int >= 1")
    if coords["tuned"] is not None and not isinstance(coords["tuned"], bool):
        p.append(f"{where}.coords.tuned: must be true, false or null")
    return p


def _result_problems(cell: Dict, where: str) -> List[str]:
    p: List[str] = []
    status = cell.get("status")
    if status not in _STATUSES:
        p.append(f"{where}.status: {status!r} not in {_STATUSES}")
    cycles = cell.get("cycles")
    if cycles is not None and not (isinstance(cycles, int)
                                   and not isinstance(cycles, bool)
                                   and cycles >= 0):
        p.append(f"{where}.cycles: must be a non-negative int or null")
    for key in ("us_cold", "us_warm"):
        v = cell.get(key)
        if v is not None and not (_is_num(v) and v >= 0):
            p.append(f"{where}.{key}: must be a non-negative number or null")
    if cell.get("us_cold") is not None and cell.get("us_warm") is None:
        # the split is the point: a cold time with no warm time is the
        # old folded-JIT bug wearing a new name
        p.append(f"{where}: us_cold without us_warm (cold/warm split "
                 f"must record both)")
    derived = cell.get("derived")
    if not isinstance(derived, dict):
        p.append(f"{where}.derived: must be an object")
    else:
        for k, v in derived.items():
            if not isinstance(k, str):
                p.append(f"{where}.derived: non-string key {k!r}")
            elif not isinstance(v, _SCALARS):
                p.append(f"{where}.derived.{k}: must be a scalar, got "
                         f"{type(v).__name__}")
    replay = cell.get("replay")
    if replay is not None and not isinstance(replay, dict):
        p.append(f"{where}.replay: must be an object or absent")
    if status == "ok" and cycles is None and cell.get("us_warm") is None \
            and not derived:
        p.append(f"{where}: an ok cell must carry cycles, us_warm or "
                 f"derived data")
    return p


def validate_report(report: object) -> Dict:
    """Raise :class:`SchemaError` on any violation; return the report."""
    problems = schema_problems(report)
    if problems:
        raise SchemaError(problems)
    assert isinstance(report, dict)
    return report
