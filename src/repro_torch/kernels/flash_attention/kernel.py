"""Decode attention on Hopper: the counted wrappers over
``csrc/flash_decode.cu`` and their plain PyTorch versions.

Replaces ``repro.kernels.flash_attention.kernel.flash_decode`` and
``flash_decode_paged``.  Both CUDA entry points share one device body and
differ only in how K/V block ``k`` is addressed; the CUDA source says
what bounds them and how the design answers.  The K/V ring depth is
``plan_rif`` over one block's bytes with half the shared memory the card
lets one block opt into as budget, then clamped to the stream length,
to ``ring.MAX_RIF`` and to what fits the card.

Lengths must be >= 1 (the serve path always passes ``pos + 1``): the
kernel visits only blocks holding a visible token.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.pipeline import SMEM_BUDGET_FRACTION, plan_rif
from repro_torch.kernels.common import (cdiv, check_status, counted,
                                        load_library, stream_ptr)
from repro_torch.kernels.flash_attention.ref import decode_ref
from repro_torch.kernels.ring import MAX_RIF, clamp_rif

__all__ = ["flash_decode", "flash_decode_paged", "decode_plain",
           "decode_paged_plain", "pages_to_cache", "DEFAULT_BK"]

# Tokens per K/V block of the contiguous decode.  The TPU kernel's 128
# matched its MXU tile; on Hopper a smaller block keeps the ring deep
# within shared memory and matches the paged decode's block (one page).
DEFAULT_BK = 32
_GROUPS = (1, 2, 4, 8)   # query rows per KV head the CUDA body instantiates
_MAX_D = 128             # flash_decode.cu kMaxD: one column per thread
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}


def pages_to_cache(pages: torch.Tensor, page_table: torch.Tensor
                   ) -> torch.Tensor:
    """(NP, KVH, PAGE, D), (B, NPB) -> contiguous (B, KVH, NPB*PAGE, D):
    the page reconstruction of JAX's ``method="ref"`` paged decode."""
    g = pages[page_table.long()]                  # (B, NPB, KVH, PAGE, D)
    b, npb, kvh, page, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, kvh, npb * page, d)


def decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 scale: float) -> torch.Tensor:
    """The contiguous decode in plain PyTorch: q (B,KVH,G,D)."""
    b, kvh, g, d = q.shape
    out = decode_ref(q.reshape(b, kvh * g, d), k_cache, v_cache, lengths,
                     scale=scale)
    return out.reshape(b, kvh, g, d)


def decode_paged_plain(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor, *, scale: float
                       ) -> torch.Tensor:
    """The paged decode in plain PyTorch: gather the pages, then decode."""
    return decode_plain(q, pages_to_cache(k_pages, page_table),
                        pages_to_cache(v_pages, page_table), lengths,
                        scale=scale)


def _lib() -> ctypes.CDLL:
    lib = load_library("flash_decode")
    if lib.flash_decode_paged.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
            ctypes.c_float
        lib.flash_decode_contig.argtypes = [p, p, p, p, p, i, i, i, i, ll, i,
                                            i, f, i, p]
        lib.flash_decode_contig.restype = ctypes.c_int
        lib.flash_decode_paged.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                           i, f, i, p]
        lib.flash_decode_paged.restype = ctypes.c_int
        lib.repro_smem_optin.argtypes = [ctypes.c_int]
        lib.repro_smem_optin.restype = ctypes.c_int
    return lib


def _check(q, k, v, lengths) -> None:
    tensors = (q, k, v, lengths)
    if any(t.device != q.device for t in tensors) or not q.is_cuda:
        raise ValueError("all tensors must lie on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in _ESIZE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (q.shape[0],):
        raise ValueError("lengths must be a (B,) int32 tensor")
    b, kvh, g, d = q.shape
    if k.shape[1] != kvh or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}")
    if g not in _GROUPS or d > _MAX_D or (d * _ESIZE[q.dtype]) % 16:
        raise ValueError(f"unsupported G={g}, D={d} for {q.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("tensors must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("K/V must be 16-byte aligned for cp.async")


def _ring_depth(lib, rif: Optional[int], bk: int, q: torch.Tensor,
                n_blocks: int) -> int:
    b, kvh, g, d = q.shape
    optin = lib.repro_smem_optin(q.device.index if q.device.index is not None
                                 else torch.cuda.current_device())
    if optin <= 0:
        raise RuntimeError("could not read the card's shared-memory opt-in")
    block = bk * (d * _ESIZE[q.dtype] + 16)     # rows one chunk apart
    if rif is None:
        rif = plan_rif(block, smem_budget=int(optin * SMEM_BUDGET_FRACTION)).rif
    rif = min(clamp_rif(rif, n_blocks), MAX_RIF)
    extra = 4 * (g * (d + 4) + g * bk + 3 * g)
    fits = (optin - extra) // (2 * block)
    if fits < 1:
        raise ValueError(f"one K/V block pair of {2 * block} bytes does not "
                         f"fit {optin} bytes of shared memory")
    return min(rif, fits)


@counted
def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 scale: float, bk: int = DEFAULT_BK,
                 rif: Optional[int] = None) -> torch.Tensor:
    """q (B, KVH, G, D); caches (B, KVH, S, D); lengths (B,) int32 >= 1
    -> (B, KVH, G, D) in q's dtype.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if all(t.device.type == "cpu" for t in (q, k_cache, v_cache, lengths)):
        return decode_plain(q, k_cache, v_cache, lengths, scale=scale)
    _check(q, k_cache, v_cache, lengths)
    b, kvh, g, d = q.shape
    s = k_cache.shape[2]
    if k_cache.shape[0] != b:
        raise ValueError("caches and q disagree on the batch size")
    lib = _lib()
    rif = _ring_depth(lib, rif, bk, q, cdiv(s, bk))
    out = torch.empty_like(q)
    status = lib.flash_decode_contig(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, kvh, g, d, s, bk, rif, scale,
        int(q.dtype == torch.bfloat16), stream_ptr(q.device))
    check_status(lib, status, "flash_decode_contig")
    flash_decode.launches += 1
    return out


@counted
def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor, *, scale: float,
                       rif: Optional[int] = None) -> torch.Tensor:
    """q (B, KVH, G, D); pages (NP, KVH, PAGE, D); page_table (B, NPB)
    int32 of pool pages; lengths (B,) int32 >= 1 -> (B, KVH, G, D).
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if all(t.device.type == "cpu"
           for t in (q, k_pages, v_pages, page_table, lengths)):
        return decode_paged_plain(q, k_pages, v_pages, page_table, lengths,
                                  scale=scale)
    _check(q, k_pages, v_pages, lengths)
    b, kvh, g, d = q.shape
    page = k_pages.shape[2]
    if (page_table.device != q.device or page_table.dtype != torch.int32
            or page_table.dim() != 2 or page_table.shape[0] != b
            or not page_table.is_contiguous()):
        raise ValueError("page_table must be a contiguous (B, NPB) int32 "
                         "tensor on q's device")
    npb = page_table.shape[1]
    lib = _lib()
    rif = _ring_depth(lib, rif, page, q, npb)
    out = torch.empty_like(q)
    status = lib.flash_decode_paged(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, kvh, g,
        d, npb, page, rif, scale, int(q.dtype == torch.bfloat16),
        stream_ptr(q.device))
    check_status(lib, status, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out
