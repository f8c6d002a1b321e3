"""Measurement helpers shared by the port's benchmarks and serve loop."""

from repro_torch.bench.timing import ColdTimer, percentile, percentiles

__all__ = ["ColdTimer", "percentile", "percentiles"]
