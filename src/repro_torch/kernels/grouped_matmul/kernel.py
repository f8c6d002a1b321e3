"""Grouped (MoE expert) matmul on Hopper: the counted wrapper over
``csrc/grouped_matmul.cu`` and its plain PyTorch version.

Replaces ``repro.kernels.grouped_matmul.kernel.gmm``.  The CUDA source
says what bounds it and how the design answers.  Unlike the TPU wrapper,
nothing pads x or w to the tile sizes: the kernel masks ragged edges
itself.  ``rif`` keeps the TPU meaning, weight tiles in flight: left
``None`` it is ``plan_rif`` over one weight tile with half the card's
shared-memory opt-in as budget, clamped to the stages (x rows and a
weight tile) that fit.  A bfloat16 tile is ``DEFAULT_BN`` columns wide
unless the private ``_bn`` says 128: the dispatcher passes its ``bf``
knob there (explicit or tuned), and ``tools/ring_sweep.py`` times both.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.common import (ELEM_BYTES, cdiv, check_operands,
                                        check_status, counted, load_library,
                                        launch, ring_depth)
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

__all__ = ["gmm", "gmm_plain", "DEFAULT_BN", "SLICE_ROWS", "STAGE_DEPTH"]

STAGE_DEPTH = 64          # grouped_matmul.cu kDepth: D of one bf16 stage
SLICE_ROWS = 128          # kRows: rows of a slice (two warpgroups of 64)
DEFAULT_BN = 256          # columns of a bf16 tile (128 or 256)
_BK_FMA = 32              # BK: D of one float32 stage


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
        lib.grouped_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                       i, i, p]
        lib.grouped_matmul.restype = ctypes.c_int
        lib.grouped_matmul_stage_bytes.argtypes = [i, i]
        lib.grouped_matmul_stage_bytes.restype = i
        for fn in (lib.grouped_matmul_weight_bytes,
                   lib.grouped_matmul_extra_bytes):
            fn.argtypes = [i]
            fn.restype = i
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
        rif: Optional[int] = None, _bn: int = DEFAULT_BN) -> torch.Tensor:
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
    bf16 = int(x.dtype == torch.bfloat16)
    if _bn not in (128, 256):
        raise ValueError(f"_bn must be 128 or 256, got {_bn}")
    dev = x.device
    out = torch.empty((t, f), dtype=x.dtype, device=dev)
    if t == 0:
        return out
    lib = _lib()
    # bfloat16 plans over one weight tile; float32 over its whole stage
    rif = ring_depth(lib, rif, lib.grouped_matmul_stage_bytes(bf16, _bn),
                     cdiv(d, STAGE_DEPTH if bf16 else _BK_FMA), dev,
                     extra_bytes=lib.grouped_matmul_extra_bytes(bf16),
                     plan_bytes=(lib.grouped_matmul_weight_bytes(_bn)
                                 if bf16 else None))
    status = launch(lib.grouped_matmul, dev,
        x.data_ptr(), w.data_ptr(), block_expert.data_ptr(),
        None if block_rows is None else block_rows.data_ptr(),
        out.data_ptr(), t, d, f, e, bt, block_expert.shape[0], _bn, rif,
        bf16)
    check_status(lib, status, "grouped_matmul")
    gmm.launches += 1
    return out
