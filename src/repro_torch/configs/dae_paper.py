"""The paper's own benchmark suite configuration (DAE4HLS §6): the seven
irregular workloads, the five HLS configurations, and the memory models
used by the benchmarks and the simulator — the same suite as
``repro.configs.dae_paper``; its ``benchmarks`` and ``configs`` are
``core.workloads.BENCHMARKS`` and ``CONFIGS``."""

DAE_SUITE = {
    "benchmarks": ("binsearch", "binsearch_for", "hashtable", "mergesort",
                   "mergesort_opt", "spmv", "multispmv"),
    "configs": ("vitis", "vitis_dec", "rhls", "rhls_stream", "rhls_dec"),
    "latency": 100,       # cycles (Verilator setup)
    "rif": 128,           # requests in flight (>= latency for full MLP)
    "moms": {             # Table 3 memory subsystem
        "cache_kib": 128,
        "max_outstanding": 64,
    },
}
