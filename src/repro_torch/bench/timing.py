"""Percentiles shared by the serve loop's reports: the port's copy of
``repro.bench.timing.percentile(s)``.  Device timing in the port uses
CUDA events (see ``chip_smoke.py``), not this module."""

from __future__ import annotations

from typing import Dict, Sequence

__all__ = ["percentile", "percentiles"]


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (numpy's default method)."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    if not values:
        raise ValueError("percentile of an empty sequence")
    xs = sorted(float(v) for v in values)
    if len(xs) == 1:
        return xs[0]
    rank = q / 100.0 * (len(xs) - 1)
    lo = int(rank)
    frac = rank - lo
    if lo + 1 >= len(xs):
        return xs[-1]
    return xs[lo] + (xs[lo + 1] - xs[lo]) * frac


def percentiles(values: Sequence[float],
                qs: Sequence[float] = (50.0, 95.0, 99.0)
                ) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` via :func:`percentile`."""
    return {f"p{q:g}": percentile(values, q) for q in qs}
