"""Decoupled block-sparse SpMV on Hopper: the counted wrapper over
``csrc/dae_spmv.cu`` and its plain PyTorch version.

Replaces ``repro.kernels.dae_spmv.kernel.bsr_spmv``.  The CUDA source
says what bounds it and how the design answers: one CTA per block row,
its blocks and their vector tiles streamed through the ring.  The ring
depth is explicit ``rif`` or ``plan_rif`` over one stage (a value block
and a vector tile), clamped by
:func:`~repro_torch.kernels.common.ring_depth`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.common import (check_operands, check_status,
                                        counted, launch, load_library,
                                        ring_depth)
from repro_torch.kernels.dae_spmv.ref import bsr_spmv_ref

__all__ = ["bsr_spmv", "bsr_spmv_plain", "MAX_BM"]

MAX_BM = 32               # dae_spmv.cu kMaxRows: one warp per block row


def _lib() -> ctypes.CDLL:
    lib = load_library("dae_spmv")
    if lib.dae_bsr_spmv.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dae_bsr_spmv.argtypes = [p, p, p, p, p, ll, ll, ll, i, i, i, p]
        lib.dae_bsr_spmv.restype = i
    return lib


def bsr_spmv_plain(val_blocks: torch.Tensor, row_ids: torch.Tensor,
                   col_ids: torch.Tensor, vec_tiles: torch.Tensor,
                   nrows_blocks: int) -> torch.Tensor:
    """The same function in plain PyTorch: one batched product of every
    block with its vector tile, then a scatter-add by block row."""
    return bsr_spmv_ref(val_blocks, row_ids, col_ids, vec_tiles,
                        nrows_blocks)


@counted
def bsr_spmv(val_blocks: torch.Tensor, row_ids: torch.Tensor,
             col_ids: torch.Tensor, vec_tiles: torch.Tensor,
             nrows_blocks: int, *, rif: Optional[int] = None
             ) -> torch.Tensor:
    """val_blocks (NB, BM, BK) float32; row_ids / col_ids (NB,) int32,
    row_ids sorted ascending; vec_tiles (KB, BK) float32 ->
    (nrows_blocks, BM) float32.  A block row with no block is zero.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    tensors = (val_blocks, row_ids, col_ids, vec_tiles)
    if all(t.device.type == "cpu" for t in tensors):
        return bsr_spmv_plain(val_blocks, row_ids, col_ids, vec_tiles,
                              nrows_blocks)
    check_operands((val_blocks, vec_tiles), (row_ids, col_ids),
                   copied=(val_blocks, vec_tiles), dtypes=(torch.float32,))
    if val_blocks.dim() != 3 or vec_tiles.dim() != 2:
        raise ValueError(f"bad shapes val_blocks {tuple(val_blocks.shape)}, "
                         f"vec_tiles {tuple(vec_tiles.shape)}")
    nb, bm, bk = val_blocks.shape
    if not 1 <= bm <= MAX_BM or bk % 4 or vec_tiles.shape[1] != bk or \
            vec_tiles.shape[0] < 1:
        raise ValueError(f"unsupported block ({bm}, {bk}) or vec_tiles "
                         f"{tuple(vec_tiles.shape)}: BM in [1, {MAX_BM}], BK "
                         "a multiple of 4")
    for name, t in (("row_ids", row_ids), ("col_ids", col_ids)):
        if t.dtype != torch.int32 or t.shape != (nb,):
            raise ValueError(f"{name} must be a ({nb},) int32 tensor")
    out = torch.empty((nrows_blocks, bm), dtype=torch.float32,
                      device=val_blocks.device)
    if nrows_blocks == 0:
        return out
    lib = _lib()
    # blocks per row vary with the data: plan for the whole stream
    rif = ring_depth(lib, rif, (bm * bk + bk) * 4, max(nb, 1),
                     val_blocks.device)
    status = launch(lib.dae_bsr_spmv, val_blocks.device,
        val_blocks.data_ptr(), row_ids.data_ptr(), col_ids.data_ptr(),
        vec_tiles.data_ptr(), out.data_ptr(), nb, nrows_blocks,
        vec_tiles.shape[0], bm, bk, rif)
    check_status(lib, status, "dae_bsr_spmv")
    bsr_spmv.launches += 1
    return out
