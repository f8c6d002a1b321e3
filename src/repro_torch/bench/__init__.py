"""Measurement helpers shared by the port's benchmarks and serve loop."""

from repro_torch.bench.timing import percentile, percentiles

__all__ = ["percentile", "percentiles"]
