"""Plain PyTorch oracle for the grouped (MoE expert) matmul: the port of
``repro.kernels.grouped_matmul.ref``."""

from __future__ import annotations

from typing import Optional

import torch


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       block_expert: torch.Tensor, bt: int, *,
                       block_rows: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """x (T, D); w (E, D, F); block_expert (ceil(T/bt),) expert id per
    token block (tokens pre-sorted by expert; a tail block shorter than
    ``bt`` keeps its block's expert).  Returns (T, F) in x's dtype, summed
    in float32.

    ``block_rows`` (ceil(T/bt),) optionally counts the real rows at the
    head of each block; the rest of the block gives zero rows (the MoE
    dispatch's zero padding multiplies to exactly that).

    One batched product over the ``(blocks, bt, D)`` view with one weight
    matrix per block, where JAX gathers a weight matrix per token: at a
    prefill of thousands of tokens that gather would take tens of GB."""
    t, d = x.shape
    nb = block_expert.shape[0]
    xb = torch.zeros((nb * bt, d), dtype=torch.float32, device=x.device)
    xb[:t] = x.float()
    xb = xb.reshape(nb, bt, d)
    if block_rows is not None:
        real = (torch.arange(bt, device=x.device)[None, :]
                < block_rows.to(x.device)[:, None])            # (NB, bt)
        xb = torch.where(real[..., None], xb, 0.0)
    out = torch.bmm(xb, w[block_expert.long()].float())        # (NB, bt, F)
    return out.reshape(nb * bt, -1)[:t].to(x.dtype)
