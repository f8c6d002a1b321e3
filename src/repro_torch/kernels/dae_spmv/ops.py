"""CSR → BSR conversion and the public wrapper for the decoupled SpMV:
the counterpart of ``repro.kernels.dae_spmv.ops``.

``method="kernel"`` (JAX's ``"pallas"``) runs ``bsr_spmv`` on CUDA
tensors and its plain version on CPU tensors; ``method="ref"`` is the
oracle.  Knobs left ``None`` resolve explicit → tune cache → analytic,
keyed as the reference keys them: ``csr_to_bsr``'s block shape on the
CSR dims (nrows, ncols, nnz), default (8, 128); ``dae_spmv``'s ``rif``
on the converted dims (NRB x BM, len(vec), NB), default ``plan_rif`` over
one vector tile's bytes.  The tuner writes its winner under both keys
(``repro_torch.tune.runners``' alias keys).  ``csr_to_bsr`` runs on the
host and looks up the winner of ``device``'s backend (``None``: the
card's; without a card the lookup misses and the defaults apply).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import (cdiv, refuse_autograd, ring_rif,
                                        round_up, tuned_knobs)
from repro_torch.kernels.dae_spmv import kernel as _k
from repro_torch.kernels.dae_spmv.ref import bsr_spmv_ref

__all__ = ["csr_to_bsr", "dae_spmv"]


def csr_to_bsr(rows: np.ndarray, cols: np.ndarray, val: np.ndarray,
               ncols: int, bm: Optional[int] = None, bk: Optional[int] = None,
               device=None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Convert scalar CSR to BSR blocks of (bm, bk): left ``None``, the
    tune cache's winner for ``device``'s backend, else (8, 128).

    Returns (val_blocks (NB, bm, bk), row_ids (NB,) int32, col_ids (NB,)
    int32, the vector length padded to whole tiles, nrows_blocks), array
    for array what the reference returns: blocks in (block_row,
    block_col) order, a zero block at column 0 for every block row with
    no entry, and duplicate entries summed in CSR order (``np.add.at``
    applies its updates in index order).  Vectorised: the reference's
    dictionary loop is O(nnz) Python steps plus O(NRB x NB) for the
    empty-row check."""
    rows, cols, val = np.asarray(rows), np.asarray(cols), np.asarray(val)
    nrows = len(rows) - 1
    if bm is None or bk is None:
        knobs = tuned_knobs("dae_spmv", (nrows, ncols, len(val)), val.dtype,
                            device, bm=(bm, 8), bk=(bk, 128))
        bm, bk = knobs["bm"], knobs["bk"]
    nrb, nkb = cdiv(nrows, bm), cdiv(ncols, bk)
    row_of = np.repeat(np.arange(nrows, dtype=np.int64),
                       np.diff(rows).astype(np.int64))
    cols = cols.astype(np.int64)
    cb = cols // bk
    span = max(nkb, int(cb.max()) + 1 if len(cb) else 1)
    keys = (row_of // bm) * span + cb                  # (block_row, block_col)
    present = np.zeros(nrb, dtype=bool)
    present[row_of // bm] = True
    empty_rows = np.flatnonzero(~present).astype(np.int64) * span
    block_keys = np.union1d(keys, empty_rows)          # sorted, unique
    val_blocks = np.zeros((len(block_keys), bm, bk), dtype=val.dtype)
    np.add.at(val_blocks, (np.searchsorted(block_keys, keys), row_of % bm,
                           cols % bk), val)
    return (val_blocks, (block_keys // span).astype(np.int32),
            (block_keys % span).astype(np.int32), nkb * bk, nrb)


def dae_spmv(val_blocks: torch.Tensor, row_ids: torch.Tensor,
             col_ids: torch.Tensor, vec: torch.Tensor, nrows_blocks: int, *,
             rif: Optional[int] = None, method: str = "kernel"
             ) -> torch.Tensor:
    """BSR matvec: returns the (nrows_blocks * BM,) flattened result.
    ``vec`` is the dense vector, padded here to whole BK tiles."""
    if method not in ("kernel", "ref"):
        raise ValueError(f"unknown method {method!r}")
    if method == "kernel":
        refuse_autograd("dae_spmv", val_blocks, vec)
    nb, bm, bk = val_blocks.shape
    if rif is None:
        rif = tuned_knobs("dae_spmv", (nrows_blocks * bm, vec.shape[0], nb),
                          val_blocks.dtype, val_blocks.device,
                          rif=(None, None))["rif"]
    kp = round_up(vec.shape[0], bk)
    if kp != vec.shape[0]:
        vec = torch.nn.functional.pad(vec, (0, kp - vec.shape[0]))
    vec_tiles = vec.contiguous().reshape(-1, bk)
    row_ids = row_ids.to(torch.int32).contiguous()
    col_ids = col_ids.to(torch.int32).contiguous()
    if method == "ref":
        out = bsr_spmv_ref(val_blocks, row_ids, col_ids, vec_tiles,
                           nrows_blocks)
    else:
        out = _k.bsr_spmv(val_blocks.contiguous(), row_ids, col_ids,
                          vec_tiles, nrows_blocks,
                          rif=ring_rif(rif, bk * vec.element_size()))
    return out.reshape(-1)
