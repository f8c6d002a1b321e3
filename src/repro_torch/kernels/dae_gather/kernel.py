"""Decoupled row gather on Hopper: the counted wrappers over
``csrc/dae_gather.cu`` and ``csrc/ring_gather.cu``, and their plain
PyTorch versions.

``gather_rows`` replaces ``repro.kernels.dae_gather.kernel.
gather_pipelined`` (the scalar-prefetch form, a grid-stride copy here);
``gather_rif`` replaces ``gather_rif`` (the explicit-ring form: one CTA
walks ``chunk`` rows with ``rif`` row copies in flight).  The ring body
also serves the compiler's ``ring_gather`` through :func:`ring_rows`.
The CUDA sources say what bounds each kernel and how the design answers.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (check_status, counted, load_library,
                                        ring_depth, stream_ptr)

__all__ = ["gather_rows", "gather_rows_plain", "gather_rif",
           "gather_rif_plain", "ring_rows", "MAX_CHUNK"]

MAX_CHUNK = 1 << 16        # rows one CTA of ring_gather.cu may own

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


# ---------------------------------------------------------------------------
# The explicit ring: gather_rif, and the compiler's ring_gather
# ---------------------------------------------------------------------------


def gather_rif_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: ``table[idx]``, indices
    clamped into ``[0, N)`` as the kernel clamps them."""
    return table[idx.long().clamp(0, max(table.shape[0] - 1, 0))]


def _ring_lib() -> ctypes.CDLL:
    lib = load_library("ring_gather")
    fn = lib.ring_gather_rows
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, ll, i, i, i, p]
        fn.restype = i
    return lib


def ring_rows(src: torch.Tensor, idx: torch.Tensor, chunk: int,
              rif: int, dtypes) -> torch.Tensor:
    """Launch ``ring_gather.cu``: ``out[k] = src[clamp(idx[k])]`` for an
    (N, W) CUDA ``src`` of one of ``dtypes`` and (M,) int32 ``idx``, one
    CTA per ``chunk`` rows (the last takes the ragged rest) with a ring of
    ``rif`` row copies, clamped to the chunk, to ``MAX_RIF`` and to the
    card's shared memory.  Raises on anything the kernel does not take."""
    if not src.is_cuda or idx.device != src.device:
        raise ValueError(f"src on {src.device} and idx on {idx.device}: "
                         "both must lie on one CUDA device")
    if src.dim() != 2 or not src.is_contiguous():
        raise ValueError("src must be a contiguous (N, W) tensor, got "
                         f"shape {tuple(src.shape)}")
    if src.dtype not in dtypes:
        raise TypeError(f"unsupported dtype {src.dtype}; the kernel takes "
                        f"{list(dtypes)}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous (M,) int32 tensor")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    if rif < 1:
        raise ValueError(f"rif must be >= 1, got {rif}")
    n, w = src.shape
    m = idx.shape[0]
    out = torch.empty((m, w), dtype=src.dtype, device=src.device)
    if m == 0 or w == 0:
        return out
    if n == 0:
        raise ValueError("cannot gather from an empty source")
    esize = src.element_size()
    pitch = -(-w * esize // 16) * 16
    lib = _ring_lib()
    depth = ring_depth(lib, rif, pitch, min(chunk, m), src.device)
    status = lib.ring_gather_rows(src.data_ptr(), idx.data_ptr(),
                                  out.data_ptr(), n, w, m, esize, chunk,
                                  depth, stream_ptr(src.device))
    check_status(lib, status, "ring_gather_rows")
    return out


@counted
def gather_rif(table: torch.Tensor, idx: torch.Tensor, *, chunk: int = 64,
               rif: int = 8) -> torch.Tensor:
    """``out[i] = table[idx[i]]`` through the explicit ring: table (N, D)
    float32/bfloat16/float16, idx (M,) int32 in ``[0, N)`` -> (M, D).
    M need not be a multiple of ``chunk``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rif_plain(table, idx)
    out = ring_rows(table, idx, chunk, rif, _ELEM_BYTES)
    if out.numel():
        gather_rif.launches += 1
    return out
