"""Public wrapper for the decoupled gather: the counterpart of
``repro.kernels.dae_gather.ops``.

``method="pipelined"`` (the default, as the JAX dispatcher resolves it
without a tuned entry) runs ``gather_rows``; ``method="rif"`` runs the
explicit ring ``gather_rif`` with ``chunk`` rows a CTA (default 64) and
``rif`` row copies in flight; ``method="ref"`` is the oracle.  The
kernels run on CUDA tensors and their plain versions on CPU tensors.
``block_d`` shapes Pallas blocks and has no counterpart here.

Knobs resolve explicit → analytic (the port has no tune cache yet):
``rif`` left ``None`` is :func:`plan_rif` over one chunk of rows, as the
reference sizes it, then clamped to ``MAX_RIF`` and to the chunk.  The
reference pads M to a multiple of the chunk with row 0 and slices the
pad off; the CUDA kernel's last CTA takes the ragged rest instead, which
gives the same rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import ring_rif
from repro_torch.kernels.dae_gather import kernel as _k
from repro_torch.kernels.dae_gather.ref import gather_ref
from repro_torch.kernels.ring import MAX_RIF


def dae_gather(table: torch.Tensor, idx: torch.Tensor, *,
               method: str = "pipelined", chunk: Optional[int] = None,
               rif: Optional[int] = None) -> torch.Tensor:
    """Decoupled gather of ``table`` (N, D) rows at ``idx`` (M,) -> (M, D)."""
    if method == "ref":
        return gather_ref(table, idx)
    idx = idx.to(torch.int32).contiguous()
    if method == "pipelined":
        return _k.gather_rows(table, idx)
    if method != "rif":
        raise ValueError(f"unknown method {method!r}")
    chunk = 64 if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    n, d = table.shape
    rif = ring_rif(rif, chunk * d * table.element_size())
    c = min(chunk, idx.shape[0]) or 1
    return _k.gather_rif(table, idx, chunk=c, rif=max(1, min(rif, MAX_RIF, c)))
