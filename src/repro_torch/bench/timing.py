"""Timing helpers: the cold/warm wall-clock measurement of benchmark
cells and the percentiles of the serve loop's reports (the port's copy
of ``repro.bench.timing``), and the cold-L2 CUDA-event timer that
``chip_smoke.py`` and ``tools/ring_sweep.py`` time kernels with.

:func:`measure` reports both sides of the cold/warm split:

  * ``us_cold`` — the very first call, one-time costs (kernel builds,
    allocator growth) included;
  * ``us_warm`` — best-of-``warm_reps`` after the cold call.  Best (not
    mean) because wall-clock noise on a shared host is strictly
    additive; the minimum is the stable lower envelope.

Both are host wall time, as in the reference, not device time: a result
that holds a CUDA tensor is waited for with ``torch.cuda.synchronize()``
before the clock is read, so asynchronous launches cannot leak past the
timer.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Sequence

import torch

__all__ = ["Timing", "measure", "percentile", "percentiles", "ColdTimer"]

L2_FLUSH_BYTES = 256 * 2**20   # > the H100's 50 MB L2
SLEEP_CYCLES = 2_000_000       # ~1 ms of device spin before each timing


@dataclasses.dataclass(frozen=True)
class Timing:
    """One cold/warm measurement, microseconds."""

    us_cold: float
    us_warm: float


def _on_card(result: object) -> bool:
    """Whether ``result`` (tensors in tuples, lists, dicts and
    dataclasses, nested) holds a CUDA tensor."""
    if isinstance(result, torch.Tensor):
        return result.is_cuda
    if isinstance(result, dict):
        return any(_on_card(v) for v in result.values())
    if isinstance(result, (tuple, list)):
        return any(_on_card(v) for v in result)
    if dataclasses.is_dataclass(result) and not isinstance(result, type):
        return any(_on_card(getattr(result, f.name))
                   for f in dataclasses.fields(result))
    return False


def _ready(result: object) -> None:
    if _on_card(result):
        torch.cuda.synchronize()


def measure(fn: Callable[[], object], *, warm_reps: int = 3) -> Timing:
    """Time ``fn`` once cold then best-of-``warm_reps``.

    A result holding a CUDA tensor is synchronised before the clock is
    read; other results pass through untouched.
    """
    t0 = time.perf_counter()
    _ready(fn())
    us_cold = (time.perf_counter() - t0) * 1e6
    best = float("inf")
    for _ in range(max(1, warm_reps)):
        t0 = time.perf_counter()
        _ready(fn())
        best = min(best, time.perf_counter() - t0)
    return Timing(us_cold=us_cold, us_warm=best * 1e6)


class ColdTimer:
    """Mean device time in ms of ``fn`` over ``iters`` calls, each timed
    with its own CUDA events after the L2 cache was overwritten.  The
    device spins for ``SLEEP_CYCLES`` before each start event, so the
    host has enqueued the timed work before the device reaches it and
    host-side launch cost stays outside the events."""

    def __init__(self, device: torch.device):
        self.flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                                 device=device)

    def __call__(self, fn: Callable, iters: int = 30,
                 warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


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
