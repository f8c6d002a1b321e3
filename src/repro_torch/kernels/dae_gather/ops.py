"""Public wrapper for the decoupled gather: the counterpart of
``repro.kernels.dae_gather.ops``.

``method="pipelined"`` (the default, as the JAX dispatcher resolves it
without a tuned entry) runs ``gather_rows``; ``method="rif"`` runs the
explicit ring ``gather_rif`` with ``chunk`` rows a CTA (default 64) and
``rif`` row copies in flight; ``method="ref"`` is the oracle.  The
kernels run on CUDA tensors and their plain versions on CPU tensors.
``block_d`` shapes Pallas blocks and has no counterpart here: it is
accepted (a positive int, or ``None``) and ignored.

Knobs left ``None`` resolve explicit → tune cache → analytic, keyed as
the reference keys them, on (N, D, M) and the table's dtype: ``method``
falls back to ``"pipelined"``, ``chunk`` to 64 and ``rif`` to
:func:`plan_rif` over one chunk of rows, as the reference sizes it, then
clamped to ``MAX_RIF`` and to the chunk.  The reference pads M to a
multiple of the chunk with row 0 and slices the pad off; the CUDA
kernel's last CTA takes the ragged rest instead, which gives the same
rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import (check_ignored, refuse_autograd,
                                        ring_rif, tuned_knobs)
from repro_torch.kernels.dae_gather import kernel as _k
from repro_torch.kernels.dae_gather.ref import gather_ref
from repro_torch.kernels.ring import MAX_RIF


def dae_gather(table: torch.Tensor, idx: torch.Tensor, *,
               method: Optional[str] = None, block_d: Optional[int] = None,
               chunk: Optional[int] = None,
               rif: Optional[int] = None) -> torch.Tensor:
    """Decoupled gather of ``table`` (N, D) rows at ``idx`` (M,) -> (M, D)."""
    check_ignored(block_d=block_d)
    n, d = table.shape
    if method is None or block_d is None or chunk is None or rif is None:
        knobs = tuned_knobs("dae_gather", (n, d, idx.shape[0]), table.dtype,
                            table.device, method=(method, "pipelined"),
                            chunk=(chunk, 64), rif=(rif, None))
        method, chunk, rif = knobs["method"], knobs["chunk"], knobs["rif"]
    if method == "ref":
        return gather_ref(table, idx)
    refuse_autograd("dae_gather", table)
    idx = idx.to(torch.int32).contiguous()
    if method == "pipelined":
        return _k.gather_rows(table, idx)
    if method != "rif":
        raise ValueError(f"unknown method {method!r}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    rif = ring_rif(rif, chunk * d * table.element_size())
    c = min(chunk, idx.shape[0]) or 1
    return _k.gather_rif(table, idx, chunk=c, rif=max(1, min(rif, MAX_RIF, c)))
