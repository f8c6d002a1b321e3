"""Plain PyTorch oracles for the decoupled SpMV: the counterpart of
``repro.kernels.dae_spmv.ref``."""

from __future__ import annotations

import torch


def spmv_ref(rows, cols, val, vec) -> torch.Tensor:
    """CSR matvec by segment sums: rows (N+1,), cols / val (NNZ,)."""
    nrows = rows.shape[0] - 1
    nnz = val.shape[0]
    row_ids = torch.searchsorted(rows[1:], torch.arange(nnz, device=val.device,
                                                        dtype=rows.dtype),
                                 right=True)
    prods = val * vec[cols.long()]
    return torch.zeros(nrows, dtype=val.dtype,
                       device=val.device).index_add_(0, row_ids, prods)


def bsr_spmv_ref(val_blocks, row_ids, col_ids, vec, nrows_blocks
                 ) -> torch.Tensor:
    """BSR oracle: val_blocks (NB, BM, BK), vec (KB, BK) ->
    (nrows_blocks, BM)."""
    bm = val_blocks.shape[1]
    prods = torch.einsum("nmk,nk->nm", val_blocks, vec[col_ids.long()])
    out = torch.zeros((nrows_blocks, bm), dtype=val_blocks.dtype,
                      device=val_blocks.device)
    return out.index_add_(0, row_ids.long(), prods)
