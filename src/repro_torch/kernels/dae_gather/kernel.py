"""Decoupled row gather on Hopper: the counted wrappers over
``csrc/dae_gather.cu`` and ``csrc/ring_gather.cu``, and their plain
PyTorch versions.

``gather_rows`` replaces ``repro.kernels.dae_gather.kernel.
gather_pipelined`` (the scalar-prefetch form; here items of (row, column
slice) of at most ``SLICE_UNITS`` units, one CTA each at a time, planned
by :func:`gather_plan`);
``gather_rif`` replaces ``gather_rif`` (the explicit-ring form: one CTA
walks ``chunk`` rows with ``rif`` row copies in flight).  The ring body
also serves the compiler's ``ring_gather`` through :func:`ring_rows`.
Rows whose size and both base pointers are 16-byte multiples take the
ring's bulk body (one issuing thread a CTA, one bulk copy in and one
out per row); the rest take its register body.
The CUDA sources say what bounds each kernel and how the design answers.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.common import (cdiv, check_status, counted,
                                        launch, load_library, ring_depth,
                                        round_up, sm_count)
from repro_torch.kernels.ring import MAX_RIF

__all__ = ["gather_rows", "gather_rows_plain", "gather_plan", "row_unit",
           "gather_rif", "gather_rif_plain", "ring_rows", "bulk_rows",
           "bulk_ctas", "MAX_CHUNK", "BULK_PERSIST_BYTES", "SLICE_UNITS",
           "MAX_GRID", "PIECE_BYTES"]

MAX_CHUNK = 1 << 16        # rows one CTA of ring_gather.cu may own
# ring_gather.cu moves a row that one ring slot cannot hold (more than
# the card's 227 KB beside the ring's barriers) in pieces of this many
# bytes; chunk and rif then count pieces
PIECE_BYTES = 16 << 10
# A bulk-body CTA whose ring holds this many bytes or more (large rows)
# is made persistent, two to an SM, where two fit: with one CTA a chunk
# the card interleaves a thousand output streams and the writes lose
# locality (tools/ring_sweep.py's CTA sweep).  Smaller rings keep one CTA
# a chunk, which is what keeps enough small rows in flight.
BULK_PERSIST_BYTES = 16 << 10

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}

# gather_rows' items: at most SLICE_UNITS units of a row (dae_gather.cu's
# kSliceUnits: 256 threads x 4 loads), walked by at most MAX_GRID CTAs
SLICE_UNITS = 1024
MAX_GRID = 1 << 20


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: ``table[idx]``."""
    return table[idx.long()]


def _lib() -> ctypes.CDLL:
    lib = load_library("dae_gather")
    fn = lib.dae_gather_rows
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, ll, i, i, i, p]
        fn.restype = i
    return lib


def row_unit(row_bytes: int, *ptrs: int) -> int:
    """The widest unit (16, 4 or 2 bytes) that divides ``row_bytes`` and
    every pointer: ``csrc/rows.cuh``'s ``pick``."""
    for unit in (16, 4):
        if row_bytes % unit == 0 and all(p % unit == 0 for p in ptrs):
            return unit
    return 2


def gather_plan(m: int, units: int):
    """``gather_rows``' items for ``m`` rows of ``units`` units:
    ``(slices, ctas)``, each row cut into ``slices`` items of at most
    ``SLICE_UNITS`` units (rows up to 16 KB of 16-byte vectors stay
    whole), walked by ``ctas`` CTAs."""
    slices = max(1, cdiv(units, SLICE_UNITS))
    return slices, min(m * slices, MAX_GRID)


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
    row_bytes = d * _ELEM_BYTES[table.dtype]
    unit = row_unit(row_bytes, table.data_ptr(), out.data_ptr())
    plan = gather_plan(m, row_bytes // unit)
    lib = _lib()
    status = launch(lib.dae_gather_rows, table.device, table.data_ptr(),
                    idx.data_ptr(), out.data_ptr(), n, row_bytes, m, unit,
                    *plan)
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
        fn.argtypes = [p, p, p, ll, ll, ll, i, i, i, i, ll, p]
        fn.restype = i
    return lib


def bulk_rows(src: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether ``src``'s rows can move as bulk copies into ``out``: row
    size and both base pointers 16-byte multiples (``rows::kVec16``)."""
    return row_unit(src.shape[1] * src.element_size(), src.data_ptr(),
                    out.data_ptr()) == 16


def bulk_ctas(ring_bytes: int, chunks: int, sms: int, smem: int) -> int:
    """CTAs of the bulk body for a ring of ``ring_bytes`` over ``chunks``
    chunks on ``sms`` SMs of ``smem`` shared bytes a block: two an SM
    (at most one a chunk) when the ring holds ``BULK_PERSIST_BYTES`` or
    more and two fit, else 0 (one CTA a chunk)."""
    if ring_bytes >= BULK_PERSIST_BYTES and 2 * ring_bytes <= smem:
        return min(chunks, 2 * sms)
    return 0


def ring_rows(src: torch.Tensor, idx: torch.Tensor, chunk: int,
              rif: int, dtypes, _ctas: Optional[int] = None
              ) -> torch.Tensor:
    """Launch ``ring_gather.cu``: ``out[k] = src[clamp(idx[k])]`` for an
    (N, W) CUDA ``src`` of one of ``dtypes`` and (M,) int32 ``idx``, one
    CTA per ``chunk`` rows (the last takes the ragged rest) with a ring of
    ``rif`` row copies, clamped to the chunk, to ``MAX_RIF`` and to the
    card's shared memory.  Rows that :func:`bulk_rows` allows take the
    bulk body on :func:`bulk_ctas` CTAs, each taking every ctas-th chunk
    (0: one CTA a chunk; ``tools/ring_sweep.py`` sets the count through
    the private ``_ctas``); the rest take the register body, one CTA a
    chunk.  A row that one slot cannot hold moves in pieces of
    ``PIECE_BYTES``, each an item of the stream (``chunk`` and ``rif``
    then count pieces).  Raises on anything the kernel does not take."""
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
    if _ctas is not None and _ctas < 0:
        raise ValueError(f"_ctas must be >= 0, got {_ctas}")
    n, w = src.shape
    m = idx.shape[0]
    out = torch.empty((m, w), dtype=src.dtype, device=src.device)
    if m == 0 or w == 0:
        return out
    if n == 0:
        raise ValueError("cannot gather from an empty source")
    bulk = bulk_rows(src, out)
    esize = src.element_size()
    row_bytes = w * esize
    lib = _ring_lib()
    index = src.device.index if src.device.index is not None else \
        torch.cuda.current_device()
    optin = lib.repro_smem_optin(index)
    # the bulk body keeps an mbarrier a slot beside the ring
    extra = 8 * MAX_RIF if bulk else 0
    piece = row_bytes if round_up(row_bytes, 16) + extra <= optin else \
        PIECE_BYTES
    items = m * cdiv(row_bytes, piece)
    pitch = round_up(piece, 16)
    depth = ring_depth(lib, rif, pitch, min(chunk, items), src.device,
                       extra_bytes=extra)
    ctas = _ctas
    if ctas is None:
        ctas = bulk_ctas(depth * pitch, cdiv(items, chunk),
                         sm_count(src.device), optin) if bulk else 0
    status = launch(lib.ring_gather_rows, src.device, src.data_ptr(),
                    idx.data_ptr(), out.data_ptr(), n, w, m, esize, chunk,
                    depth, ctas, piece)
    check_status(lib, status, "ring_gather_rows")
    return out


@counted
def gather_rif(table: torch.Tensor, idx: torch.Tensor, *, chunk: int = 64,
               rif: int = 8) -> torch.Tensor:
    """``out[i] = table[idx[i]]`` through the explicit ring: table (N, D)
    float32/bfloat16/float16, idx (M,) int32 in ``[0, N)`` -> (M, D).
    M need not be a multiple of ``chunk``.  The body, bulk or register,
    follows from the rows (:func:`ring_rows`).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rif_plain(table, idx)
    out = ring_rows(table, idx, chunk, rif, _ELEM_BYTES)
    if out.numel():
        gather_rif.launches += 1
    return out
