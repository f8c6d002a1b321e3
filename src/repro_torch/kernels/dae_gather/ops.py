"""Public wrapper for the decoupled gather: the counterpart of
``repro.kernels.dae_gather.ops``.

``method="pipelined"`` (the default, as the JAX dispatcher resolves it
without a tuned entry) runs the Hopper kernel on CUDA tensors and its
plain version on CPU tensors; ``method="ref"`` is the oracle.  The TPU
knobs ``block_d``/``chunk``/``rif`` shape Pallas blocks and have no
counterpart in the CUDA kernel; ``method="rif"`` waits for
``gather_rif``'s port.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dae_gather import kernel as _k
from repro_torch.kernels.dae_gather.ref import gather_ref


def dae_gather(table: torch.Tensor, idx: torch.Tensor, *,
               method: str = "pipelined") -> torch.Tensor:
    """Decoupled gather of ``table`` (N, D) rows at ``idx`` (M,) -> (M, D)."""
    if method == "ref":
        return gather_ref(table, idx)
    if method != "pipelined":
        raise ValueError(f"unknown method {method!r}")
    return _k.gather_rows(table, idx.to(torch.int32).contiguous())
