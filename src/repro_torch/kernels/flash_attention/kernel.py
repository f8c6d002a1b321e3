"""Attention on Hopper: the counted wrappers over ``csrc/flash_decode.cu``
and ``csrc/flash_prefill.cu``, and their plain PyTorch versions.

Replaces ``repro.kernels.flash_attention.kernel.flash_decode`` and
``flash_decode_paged`` (one CUDA body that differs only in how K/V block
``k`` is addressed) and ``flash`` (forward attention without a cache).
The CUDA sources say what bounds them and how the designs answer.  Each
K/V ring depth is ``plan_rif`` over one block's bytes with half the
shared memory the card lets one block opt into as budget, then clamped
to the stream length, to ``ring.MAX_RIF`` and to what fits the card.

Decode lengths must be >= 1 (the serve path always passes ``pos + 1``):
the kernel visits only blocks holding a visible token.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.common import (ELEM_BYTES, cdiv, check_operands,
                                        check_status, counted, load_library,
                                        ring_depth, stream_ptr)
from repro_torch.kernels.flash_attention.ref import attention_ref, decode_ref

__all__ = ["flash", "flash_decode", "flash_decode_paged", "attention_plain",
           "decode_plain", "decode_paged_plain", "pages_to_cache",
           "DEFAULT_BK"]

# Tokens per K/V block of the contiguous decode.  The TPU kernel's 128
# matched its MXU tile; on Hopper a smaller block keeps the ring deep
# within shared memory and matches the paged decode's block (one page).
DEFAULT_BK = 32
_GROUPS = range(1, 9)    # query rows per KV head the CUDA body instantiates
_MAX_D = 128             # flash_decode.cu kMaxD: one column per thread
_PREFILL_D = (16, 32, 64, 128)   # head dims flash_prefill.cu instantiates


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
    return lib


def _check(q, k, v, lengths) -> None:
    check_operands((q, k, v), (lengths,), copied=(k, v))
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (q.shape[0],):
        raise ValueError("lengths must be a (B,) int32 tensor")
    b, kvh, g, d = q.shape
    if k.shape[1] != kvh or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}")
    if g not in _GROUPS or d > _MAX_D or (d * ELEM_BYTES[q.dtype]) % 16:
        raise ValueError(f"unsupported G={g}, D={d} for {q.dtype}")


def _ring_depth(lib, rif: Optional[int], bk: int, q: torch.Tensor,
                n_blocks: int) -> int:
    b, kvh, g, d = q.shape
    block = bk * (d * ELEM_BYTES[q.dtype] + 16)     # rows one chunk apart
    # q, scores and softmax statistics sit beside the ring; each stage
    # holds a K and a V block, and each of the two streams plans its own
    # depth (two RingChannels in the TPU kernel)
    extra = 4 * (g * (d + 4) + g * bk + 3 * g)
    return ring_depth(lib, rif, 2 * block, n_blocks, q.device, extra,
                      plan_bytes=block)


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


# ---------------------------------------------------------------------------
# Forward attention without a cache (prefill)
# ---------------------------------------------------------------------------


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: Optional[int], scale: float
                    ) -> torch.Tensor:
    """The forward attention in plain PyTorch: the port's
    ``attention_ref``."""
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)


def _prefill_lib() -> ctypes.CDLL:
    lib = load_library("flash_prefill")
    if lib.flash_prefill.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_prefill.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, f,
                                      i, i, p]
        lib.flash_prefill.restype = i
        lib.flash_prefill_block_keys.argtypes = [i]
        lib.flash_prefill_block_keys.restype = i
        lib.flash_prefill_stage_bytes.argtypes = [i, i]
        lib.flash_prefill_stage_bytes.restype = i
    return lib


@counted
def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool, window: Optional[int], scale: float,
          rif: Optional[int] = None) -> torch.Tensor:
    """q (B, H, Sq, D); k, v (B, KVH, Sk, D) with H % KVH == 0 ->
    (B, H, Sq, D) in q's dtype.  Query row i sees key j < Sk with
    ``j <= i`` when causal and ``j >= i - window + 1`` when windowed.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale)
    check_operands((q, k, v), copied=(k, v))
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != d or h % kvh
            or d not in _PREFILL_D):
        raise ValueError(f"unsupported q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)} (D must be one of {_PREFILL_D})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty_like(q)
    if sq == 0:
        return out
    lib = _prefill_lib()
    bf16 = int(q.dtype == torch.bfloat16)
    rif = ring_depth(lib, rif, lib.flash_prefill_stage_bytes(d, bf16),
                     cdiv(sk, lib.flash_prefill_block_keys(bf16)), q.device)
    status = lib.flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kvh,
        sq, sk, d, int(causal), window or 0, scale, rif, bf16,
        stream_ptr(q.device))
    check_status(lib, status, "flash_prefill")
    flash.launches += 1
    return out
