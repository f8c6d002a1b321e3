"""Grouped (MoE expert) matmul on Hopper: the counted wrapper over
``csrc/grouped_matmul.cu`` and its plain PyTorch version.

Replaces ``repro.kernels.grouped_matmul.kernel.gmm``.  The CUDA source
says what bounds it and how the design answers.  Unlike the TPU wrapper,
nothing pads x or w to the tile sizes: the kernel masks ragged edges
itself.  The ring depth is ``plan_rif`` over one stage (x rows and a
w tile) with half the card's shared-memory opt-in as budget.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.common import (ELEM_BYTES, cdiv, check_operands,
                                        check_status, counted, load_library,
                                        ring_depth, stream_ptr)
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

__all__ = ["gmm", "gmm_plain"]

_BK = 32                  # grouped_matmul.cu BK: the depth of one stage


def gmm_plain(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
              *, bt: int, block_rows: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """The same function in plain PyTorch: one float32 ``bmm`` over the
    ``(blocks, bt, D)`` view of x."""
    return grouped_matmul_ref(x, w, block_expert, bt, block_rows=block_rows)


def _lib() -> ctypes.CDLL:
    lib = load_library("grouped_matmul")
    if lib.grouped_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grouped_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                       p]
        lib.grouped_matmul.restype = ctypes.c_int
        lib.grouped_matmul_stage_bytes.argtypes = [i]
        lib.grouped_matmul_stage_bytes.restype = i
    return lib


def _check(x, w, block_expert, block_rows, bt) -> None:
    blocks = [block_expert] + ([] if block_rows is None else [block_rows])
    check_operands((x, w), blocks, copied=(x, w))
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    nb = cdiv(x.shape[0], bt)
    for name, t in (("block_expert", block_expert),
                    ("block_rows", block_rows)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (nb,)):
            raise ValueError(f"{name} must be a ({nb},) int32 tensor")
    esize = ELEM_BYTES[x.dtype]
    if (x.shape[1] * esize) % 16 or (w.shape[2] * esize) % 16:
        raise ValueError(f"D={x.shape[1]} and F={w.shape[2]} must fill whole "
                         f"16-byte chunks of {x.dtype}")


@counted
def gmm(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor, *,
        bt: int, block_rows: Optional[torch.Tensor] = None,
        rif: Optional[int] = None) -> torch.Tensor:
    """x (T, D); w (E, D, F); block_expert (ceil(T/bt),) int32 expert of
    each token block; block_rows (ceil(T/bt),) int32 real rows at the
    head of each block, or None (all real) -> (T, F) in x's dtype.  Rows
    past a block's real ones come out as exact zeros.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    tensors = [x, w, block_expert] + ([] if block_rows is None
                                      else [block_rows])
    if all(t.device.type == "cpu" for t in tensors):
        return gmm_plain(x, w, block_expert, bt=bt, block_rows=block_rows)
    _check(x, w, block_expert, block_rows, bt)
    t, d = x.shape
    e, _, f = w.shape
    out = torch.empty((t, f), dtype=x.dtype, device=x.device)
    if t == 0:
        return out
    lib = _lib()
    bf16 = int(x.dtype == torch.bfloat16)
    rif = ring_depth(lib, rif, lib.grouped_matmul_stage_bytes(bf16),
                     cdiv(d, _BK), x.device)
    status = lib.grouped_matmul(
        x.data_ptr(), w.data_ptr(), block_expert.data_ptr(),
        None if block_rows is None else block_rows.data_ptr(),
        out.data_ptr(), t, d, f, e, bt, block_expert.shape[0], rif, bf16,
        stream_ptr(x.device))
    check_status(lib, status, "grouped_matmul")
    gmm.launches += 1
    return out
