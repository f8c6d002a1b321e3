"""Timing helpers: the percentiles of the serve loop's reports (the
port's copy of ``repro.bench.timing.percentile(s)``) and the cold-L2
CUDA-event timer that ``chip_smoke.py`` and ``tools/ring_sweep.py`` time
kernels with."""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

__all__ = ["percentile", "percentiles", "ColdTimer"]

L2_FLUSH_BYTES = 256 * 2**20   # > the H100's 50 MB L2
SLEEP_CYCLES = 2_000_000       # ~1 ms of device spin before each timing


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
