"""Decoupled row gather on Hopper: the counted wrapper over
``csrc/dae_gather.cu`` and its plain PyTorch version.

Replaces ``repro.kernels.dae_gather.kernel.gather_pipelined`` (the
scalar-prefetch form).  The CUDA source says what bounds it and how the
design answers; ``gather_rif`` (the explicit-ring form) is not ported
yet.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (check_status, counted, load_library,
                                        stream_ptr)

__all__ = ["gather_rows", "gather_rows_plain"]

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: ``table[idx]``."""
    return table[idx.long()]


def _lib() -> ctypes.CDLL:
    lib = load_library("dae_gather")
    fn = lib.dae_gather_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@counted
def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[idx[i]]``: table (N, D) float32/bfloat16/float16,
    idx (M,) int32 in ``[0, N)`` -> (M, D).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if not table.is_cuda or idx.device != table.device:
        raise ValueError(f"table on {table.device} and idx on {idx.device}: "
                         "both must lie on one CUDA device")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous (N, D) tensor")
    if table.dtype not in _ELEM_BYTES:
        raise TypeError(f"unsupported table dtype {table.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous (M,) int32 tensor")
    n, d = table.shape
    m = idx.shape[0]
    out = torch.empty((m, d), dtype=table.dtype, device=table.device)
    if m == 0 or d == 0:
        return out
    esize = _ELEM_BYTES[table.dtype]
    vec = int((d * esize) % 16 == 0 and table.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    lib = _lib()
    status = lib.dae_gather_rows(table.data_ptr(), idx.data_ptr(),
                                 out.data_ptr(), n, d, m, esize, vec,
                                 stream_ptr(table.device))
    check_status(lib, status, "dae_gather_rows")
    gather_rows.launches += 1
    return out
