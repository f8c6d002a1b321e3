"""Public decoupled access/execute ops: the paper's technique as a
composable PyTorch layer, the counterpart of ``repro.core.decouple``.

The ops take ``method="kernel"`` (JAX's ``"pallas"``), which launches
the hand-written Hopper kernel on CUDA tensors and runs its plain
PyTorch version on CPU tensors, or ``method="ref"``, the oracle.
``decoupled_gather`` names its kernels as the reference does:
``method="pipelined"`` (the default, ``gather_rows``) or ``"rif"`` (the
explicit ring ``gather_rif``, with ``chunk`` and ``rif`` knobs), besides
``"ref"``.  Knobs
left ``None`` resolve explicit → analytic: the requests-in-flight knob
``rif`` is the ring depth, sized by :func:`plan_rif` from the latency
x bandwidth product; the port has no tune cache yet.

The TPU emitter the reference re-exports here (``RingChannel``,
``access_execute``, ``ring_step``, ``ring_scratch_shapes``) has its
Hopper form in ``csrc/ring.cuh``: a ``rif``-stage shared-memory ring
filled by ``cp.async`` commit groups, one CTA owning a whole request
stream, with ``ring::access_execute`` as the prologue / steady-state /
drain loop.  It lives inside the CUDA kernels and has no Python API;
``repro_torch.kernels.ring`` keeps the host-side depth arithmetic.

This module is not imported by ``repro_torch.core``'s ``__init__``: the
kernel layer imports ``repro_torch.core.pipeline``, and a re-export there
would close an import cycle.
"""

from __future__ import annotations

from repro_torch.core.pipeline import RifPlan, plan_rif
from repro_torch.kernels.dae_chase.ops import (
    batched_searchsorted as decoupled_searchsorted,
    hash_lookup as decoupled_hash_lookup,
)
from repro_torch.kernels.dae_gather.ops import dae_gather as decoupled_gather
from repro_torch.kernels.dae_merge.ops import merge_sort as decoupled_merge_sort
from repro_torch.kernels.dae_merge.ops import merge_sorted as decoupled_merge
from repro_torch.kernels.dae_spmv.ops import csr_to_bsr
from repro_torch.kernels.dae_spmv.ops import dae_spmv as decoupled_spmv
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_decode,
                                                     flash_decode_paged)
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul

__all__ = [
    "plan_rif",
    "RifPlan",
    "decoupled_gather",
    "decoupled_spmv",
    "csr_to_bsr",
    "decoupled_merge",
    "decoupled_merge_sort",
    "decoupled_searchsorted",
    "decoupled_hash_lookup",
    "flash_attention",
    "flash_decode",
    "flash_decode_paged",
    "grouped_matmul",
]
