"""Regression diff between a fresh BENCH report and a committed baseline
(the port of ``repro.bench.diffing``: the same findings in the same
order).

Two signals with two disciplines:

  * **cycles** (and integer ``derived`` values, and ``status``) come
    from the pure-Python simulator or count structure (tokens, steps,
    page allocations, kernel launches) — deterministic across runs, so
    *any* change is a finding.  A faster cycle count still fails the
    gate: an unexplained improvement is a model change that needs a
    deliberate baseline refresh, not a free win.
  * **us_warm** is wall-clock — environment-dependent, so it gates only
    on slowdowns past ``wall_pct`` percent (CI uses a deliberately
    lenient band; the tight signal is cycles).  ``us_cold`` is recorded
    but never gated: first-call JIT time is too noisy to pin.

Intentional changes go through the allowlist: ``fnmatch`` patterns
(one per line, ``#`` comments) matched against ``axis/cell-name``.
An allowlisted finding is still reported — as a note, not a failure —
so the diff output stays an honest changelog.  Cells *removed* from
the fresh run fail the gate outright: silently shrinking coverage is
the failure mode the matrix exists to prevent.
"""

from __future__ import annotations

import dataclasses
from fnmatch import fnmatchcase
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = ["Finding", "FAIL_KINDS", "diff_reports", "parse_allowlist",
           "regressions"]

# finding kinds that fail the gate (unless allowlisted)
FAIL_KINDS = ("mode", "removed-cell", "status", "cycles", "wall-clock",
              "derived", "coords")
NOTE_KINDS = ("new-cell", "wall-clock-improved")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One named-cell difference between baseline and fresh run."""

    axis: str
    cell: str
    kind: str
    detail: str
    allowed: bool = False

    @property
    def fails(self) -> bool:
        return self.kind in FAIL_KINDS and not self.allowed

    def render(self) -> str:
        tag = "ALLOWED" if self.allowed else (
            "FAIL" if self.kind in FAIL_KINDS else "note")
        return f"[{tag}] {self.axis}/{self.cell}: {self.kind} — {self.detail}"


def parse_allowlist(text: str) -> Tuple[str, ...]:
    """Allowlist file format: one fnmatch pattern per line, ``#`` comments."""
    out: List[str] = []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            out.append(line)
    return tuple(out)


def _allowed(axis: str, cell: str, patterns: Sequence[str]) -> bool:
    key = f"{axis}/{cell}"
    return any(fnmatchcase(key, pat) for pat in patterns)


def _cells_by_name(report: Dict) -> Dict[str, Dict]:
    return {c["name"]: c for c in report["cells"]}


def diff_reports(baseline: Dict, fresh: Dict, *, wall_pct: float = 25.0,
                 allowlist: Sequence[str] = ()) -> List[Finding]:
    """All findings between two schema-valid reports of the same axis."""
    axis = fresh.get("axis", "?")
    findings: List[Finding] = []

    def add(cell: str, kind: str, detail: str) -> None:
        findings.append(Finding(axis, cell, kind, detail,
                                allowed=_allowed(axis, cell, allowlist)))

    if baseline.get("axis") != fresh.get("axis"):
        add("*", "mode", f"axis mismatch: baseline "
            f"{baseline.get('axis')!r} vs fresh {fresh.get('axis')!r}")
        return findings
    if baseline.get("smoke") != fresh.get("smoke"):
        add("*", "mode", f"smoke mismatch: baseline "
            f"smoke={baseline.get('smoke')} vs fresh "
            f"smoke={fresh.get('smoke')} — compare like against like")
        return findings

    base_cells = _cells_by_name(baseline)
    fresh_cells = _cells_by_name(fresh)
    for name in base_cells:
        if name not in fresh_cells:
            add(name, "removed-cell",
                "present in baseline but missing from the fresh run "
                "(coverage shrank)")
    for name in fresh_cells:
        if name not in base_cells:
            add(name, "new-cell", "not in baseline (refresh to pin it)")

    for name in sorted(set(base_cells) & set(fresh_cells)):
        findings.extend(
            _diff_cell(axis, base_cells[name], fresh_cells[name],
                       wall_pct=wall_pct, allowlist=allowlist))
    return findings


def _diff_cell(axis: str, base: Dict, fresh: Dict, *, wall_pct: float,
               allowlist: Sequence[str]) -> List[Finding]:
    name = base["name"]
    out: List[Finding] = []

    def add(kind: str, detail: str) -> None:
        out.append(Finding(axis, name, kind, detail,
                           allowed=_allowed(axis, name, allowlist)))

    if base["coords"] != fresh["coords"]:
        add("coords", f"coordinates changed: {base['coords']} -> "
            f"{fresh['coords']}")
    if base["status"] != fresh["status"]:
        add("status", f"{base['status']} -> {fresh['status']}")
        return out  # cycle/time comparisons are meaningless across states

    bc, fc = base.get("cycles"), fresh.get("cycles")
    if bc != fc:
        if bc is None or fc is None:
            add("cycles", f"cycles went {bc} -> {fc}")
        else:
            direction = "regressed" if fc > bc else "improved"
            add("cycles", f"{direction}: {bc} -> {fc} "
                f"({fc - bc:+d} cycles; cycle counts are deterministic — "
                f"refresh the baseline if intentional)")

    bw, fw = base.get("us_warm"), fresh.get("us_warm")
    if bw is not None and fw is not None and bw > 0:
        ratio = 100.0 * (fw - bw) / bw
        if ratio > wall_pct:
            add("wall-clock", f"warm time regressed {ratio:.0f}% "
                f"({bw:.1f}us -> {fw:.1f}us, gate {wall_pct:.0f}%)")
        elif ratio < -wall_pct:
            add("wall-clock-improved",
                f"warm time improved {-ratio:.0f}% "
                f"({bw:.1f}us -> {fw:.1f}us)")

    bd, fd = base.get("derived", {}), fresh.get("derived", {})
    for key in sorted(set(bd) | set(fd)):
        b, f = bd.get(key), fd.get(key)
        b_int = isinstance(b, int) and not isinstance(b, bool)
        f_int = isinstance(f, int) and not isinstance(f, bool)
        # ints are deterministic side-channels (channel counts, buffer
        # bytes, golden cycles); floats/strings are informational only
        if (b_int or f_int) and b != f:
            add("derived", f"derived[{key}]: {b!r} -> {f!r}")
    return out


def regressions(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.fails]
