"""Deterministic searchers over decoupling-parameter spaces: the port's
copy of ``repro.tune.search``, unchanged in what it visits and returns.

Two strategies, selected automatically by space size:

* exhaustive grid for small spaces;
* greedy hill-climb from the analytic seed (`plan_rif`) for larger ones —
  evaluate the ±1-step neighbourhood on every axis, move to the best
  neighbour, stop when no neighbour improves or the eval budget runs out.

Both are deterministic: configs are visited in a fixed order, ties break
toward the earlier-visited (and therefore seed-closer) config, and the
only randomness allowed anywhere is the ``seed`` the measurement
function may use for its own input data.

A measurement returning ``inf`` (or raising one of the exception types in
``PENALIZED``) marks the config invalid — notably a simulated deadlock
from an undersized channel capacity (§5.3); the searcher treats it as an
infinitely bad score rather than an error, so the boundary of the
deadlock-free region is mapped, not tripped over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.dae import ConservationError
from repro_torch.core.simulator import DeadlockError
from repro_torch.tune.space import Config, SearchSpace

__all__ = ["TuneResult", "search", "grid_search", "hill_climb", "PENALIZED"]

PENALIZED: Tuple[type, ...] = (DeadlockError, ConservationError)

Measure = Callable[[Config], float]


@dataclasses.dataclass
class TuneResult:
    space: str
    best: Config
    best_score: float
    seed: Config
    seed_score: float
    evals: int
    trace: List[Tuple[Config, float]]   # evaluation order, for debugging

    @property
    def improvement(self) -> float:
        """seed_score / best_score (>= 1.0 when the tuner helped)."""
        if not math.isfinite(self.seed_score) or self.best_score <= 0:
            return float("inf") if math.isfinite(self.best_score) else 1.0
        return self.seed_score / self.best_score


def _key(cfg: Config) -> Tuple:
    return tuple(sorted(cfg.items()))


class _Memo:
    """Evaluate-once wrapper that maps penalized failures to +inf."""

    def __init__(self, measure: Measure):
        self.measure = measure
        self.scores: Dict[Tuple, float] = {}
        self.trace: List[Tuple[Config, float]] = []

    def __call__(self, cfg: Config) -> float:
        k = _key(cfg)
        if k in self.scores:
            return self.scores[k]
        try:
            s = float(self.measure(cfg))
        except PENALIZED:
            s = float("inf")
        if math.isnan(s):
            s = float("inf")
        self.scores[k] = s
        self.trace.append((dict(cfg), s))
        return s

    @property
    def evals(self) -> int:
        return len(self.scores)


def grid_search(space: SearchSpace, measure: Measure,
                max_evals: Optional[int] = None) -> TuneResult:
    """Exhaustively evaluate the grid (optionally capped at max_evals,
    seed first so the cap never loses the analytic baseline)."""
    memo = _Memo(measure)
    seed = space.snap(space.seed)
    seed_score = memo(seed)
    best, best_score = dict(seed), seed_score
    for cfg in space.grid():
        if max_evals is not None and memo.evals >= max_evals:
            break
        s = memo(cfg)
        if s < best_score:
            best, best_score = dict(cfg), s
    return TuneResult(space.name, best, best_score, seed, seed_score,
                      memo.evals, memo.trace)


def hill_climb(space: SearchSpace, measure: Measure,
               max_evals: int = 64) -> TuneResult:
    """Greedy best-neighbour descent from the analytic seed."""
    memo = _Memo(measure)
    cur = space.snap(space.seed)
    cur_score = memo(cur)
    seed, seed_score = dict(cur), cur_score
    while memo.evals < max_evals:
        best_n, best_n_score = None, cur_score
        for n in space.neighbours(cur):
            if memo.evals >= max_evals:
                break
            s = memo(n)
            if s < best_n_score:
                best_n, best_n_score = n, s
        if best_n is None:
            break
        cur, cur_score = best_n, best_n_score
    # the climb can start from an infeasible (deadlocking) seed: if it never
    # escaped, fall back to a coarse probe of the grid corners
    if not math.isfinite(cur_score):
        for cfg in space.grid():
            if memo.evals >= max_evals:
                break
            s = memo(cfg)
            if s < cur_score:
                cur, cur_score = dict(cfg), s
    return TuneResult(space.name, cur, cur_score, seed, seed_score,
                      memo.evals, memo.trace)


def search(space: SearchSpace, measure: Measure, *, max_evals: int = 64,
           strategy: str = "auto") -> TuneResult:
    """Tune ``space`` with ``measure`` (lower is better).

    ``strategy``: 'grid', 'hill', or 'auto' (grid when the whole space
    fits in the eval budget, hill-climb otherwise).
    """
    if strategy == "auto":
        strategy = "grid" if space.size <= max_evals else "hill"
    if strategy == "grid":
        return grid_search(space, measure, max_evals=max_evals)
    if strategy == "hill":
        return hill_climb(space, measure, max_evals=max_evals)
    raise ValueError(f"unknown strategy {strategy!r}")
