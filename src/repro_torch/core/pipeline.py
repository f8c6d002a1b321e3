"""RIF planning: how many requests in flight does a ring need?

The counterpart of ``repro.core.pipeline`` with the same rule (paper
§4.2, "as many values should be looked up in parallel as the memory
latency in cycles"): the bytes in flight must cover latency × bandwidth,
so the ring depth is that divided by the block size, clamped by the
on-chip budget.  On the H100 the budget is the shared memory one block
may opt into (``cudaDevAttrMaxSharedMemoryPerBlockOptin``), and the
bandwidth is the data sheet's.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3.
HBM_BW = 3.35e12              # bytes/s
# Assumption, not a measurement: issue-to-land time of one cp.async copy
# from HBM to shared memory under load.
DMA_LATENCY_S = 1e-6
# 227 KB (232,448 bytes) a block may opt into on sm_90; used where no
# card can be asked (the CPU path plans for the card it would run on).
SMEM_OPTIN_BYTES = 232_448
SMEM_BUDGET_FRACTION = 0.5


@dataclasses.dataclass
class RifPlan:
    rif: int                 # buffers in flight
    block_bytes: int
    inflight_bytes: int
    smem_fraction: float
    note: str


def plan_rif(block_bytes: int, *, latency_s: float = DMA_LATENCY_S,
             bandwidth: float = HBM_BW, smem_budget: int | None = None,
             min_rif: int = 2, max_rif: int = 64) -> RifPlan:
    """Choose the buffer-ring depth for a decoupled stream of
    ``block_bytes`` blocks.  ``smem_budget`` defaults to half the sm_90
    opt-in; a kernel wrapper passes half of what its card reports."""
    smem_budget = smem_budget or int(SMEM_OPTIN_BYTES * SMEM_BUDGET_FRACTION)
    need_bytes = latency_s * bandwidth
    rif_latency = max(min_rif, int(need_bytes // max(block_bytes, 1)) + 1)
    rif_smem = max(1, smem_budget // max(block_bytes, 1))
    rif = max(min_rif, min(rif_latency, rif_smem, max_rif))
    note = ("latency-bound" if rif == rif_latency else
            "smem-bound" if rif == rif_smem else "clamped")
    return RifPlan(rif=rif, block_bytes=block_bytes,
                   inflight_bytes=rif * block_bytes,
                   smem_fraction=rif * block_bytes / smem_budget, note=note)
