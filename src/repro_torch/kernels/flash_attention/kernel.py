"""Attention on Hopper: the counted wrappers over ``csrc/flash_decode.cu``,
``csrc/flash_decode_paged.cu`` (both the split-KV body of
``csrc/split_decode.cuh``) and ``csrc/flash_prefill.cu``, and their plain
PyTorch versions.

Replaces ``repro.kernels.flash_attention.kernel.flash_decode`` (the
contiguous decode), ``flash_decode_paged`` (a split-KV decode fed by
bulk page copies) and ``flash`` (forward attention without a cache).
The CUDA sources say what bounds them and how the designs answer.  Both
decodes split a request's blocks across CTAs (:func:`paged_splits`) and
keep :func:`_paged_depth` blocks in flight per warp; the contiguous
cache is read as a paged one whose block j of (b, h) is rows
``j*bk .. j*bk + bk - 1`` of that head.  ``flash``'s K/V ring depth is
``plan_rif`` over one stage's bytes with half the shared memory the card
lets one block opt into as budget, then clamped to the stream length, to
``ring.MAX_RIF`` and to what fits the card beside its Q tile.

Decode lengths must be >= 1 (the serve path always passes ``pos + 1``):
the kernels visit only blocks holding a visible token.  The decodes take
any G (query rows per KV head): above 8 the CUDA body walks each block
once for sub-groups of at most 8 rows, their softmax state in shared
memory, and a request's splits grow longer where the split merge would
not fit a CTA's shared memory.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.common import (ELEM_BYTES, cdiv, check_operands,
                                        check_status, counted, load_library,
                                        launch, ring_depth, sm_count,
                                        stream_ptr)
from repro_torch.kernels.flash_attention.ref import attention_ref, decode_ref
from repro_torch.kernels.ring import MAX_RIF

__all__ = ["flash", "flash_decode", "flash_decode_paged", "attention_plain",
           "decode_plain", "decode_paged_plain", "pages_to_cache",
           "paged_splits", "fit_splits", "prefill_block_keys",
           "DEFAULT_BK"]

# Tokens per K/V block of the contiguous decode: one bulk copy of K and
# one of V per block, as a page of the paged decode (whose pages are 16
# tokens on the serve path).  tools/ring_sweep.py: 16 beats 32 by 15 % at
# 8 x 2048 tokens and ties it at mixed lengths; 64 loses at both.
DEFAULT_BK = 16
_MAX_D = 192             # kMaxD of split_decode.cuh
# The split-KV decodes (split_decode.cuh): warps per CTA (kWarps), each
# owning whole blocks, and CTAs per SM their splits aim for: four, so
# that 4 x 4 warps hide each other's latency (a warp's block is a chain
# of dependent shared-memory loads, shuffles and FMAs)
PAGED_WARPS = 4
PAGED_CTAS_PER_SM = 4
_PREFILL_D = (16, 32, 64, 96, 128, 192)   # head dims flash_prefill.cu takes


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


def _split_lib(name: str, entry: str, n_ptrs: int) -> ctypes.CDLL:
    """One of the two split-KV decode libraries: ``entry`` takes
    ``n_ptrs`` pointers, nine ints, the scale, the dtype flag and the
    stream."""
    lib = load_library(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * n_ptrs + [i] * 9 + [f, i, p]
        fn.restype = i
        lib.split_decode_smem.argtypes = [i] * 7
        lib.split_decode_smem.restype = ctypes.c_longlong
        lib.split_decode_partial.argtypes = [i, i]
        lib.split_decode_partial.restype = ctypes.c_longlong
    return lib


def _lib() -> ctypes.CDLL:
    return _split_lib("flash_decode", "flash_decode_contig", 7)


def _paged_lib() -> ctypes.CDLL:
    return _split_lib("flash_decode_paged", "flash_decode_paged", 8)


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
    if g < 1 or d > _MAX_D or (d * ELEM_BYTES[q.dtype]) % 16:
        raise ValueError(f"unsupported G={g}, D={d} for {q.dtype}")


@counted
def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 scale: float, bk: int = DEFAULT_BK,
                 rif: Optional[int] = None) -> torch.Tensor:
    """q (B, KVH, G, D); caches (B, KVH, S, D); lengths (B,) int32 >= 1
    -> (B, KVH, G, D) in q's dtype.  ``bk`` tokens per block; ``rif`` is
    the blocks in flight per CTA (:func:`_paged_depth`).  One launch per
    call.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if all(t.device.type == "cpu" for t in (q, k_cache, v_cache, lengths)):
        return decode_plain(q, k_cache, v_cache, lengths, scale=scale)
    _check(q, k_cache, v_cache, lengths)
    b, kvh, g, d = q.shape
    s = k_cache.shape[2]
    if k_cache.shape[0] != b:
        raise ValueError("caches and q disagree on the batch size")
    if bk < 1:
        raise ValueError(f"bk must be >= 1, got {bk}")
    out = torch.empty_like(q)
    if s == 0:                       # no token: every row is masked
        return out.zero_()
    lib = _lib()
    part, counters, split = _split_args(lib, rif, q, cdiv(s, bk), bk)
    status = launch(lib.flash_decode_contig, q.device,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), _ptr(part), counters.data_ptr(),
        b, kvh, g, d, s, bk, *split, scale, int(q.dtype == torch.bfloat16))
    check_status(lib, status, "flash_decode_contig")
    flash_decode.launches += 1
    return out


def paged_splits(batch: int, kvh: int, npb: int, sms: int
                 ) -> Tuple[int, int]:
    """The split-KV decodes' split of each request's ``npb`` blocks
    (pages, or ``bk``-token blocks of a contiguous cache): (blocks per
    split, splits).  Enough splits that ``batch x kvh x splits`` puts
    ``PAGED_CTAS_PER_SM`` CTAs on each of the card's ``sms``, but at
    least one block per warp in a split.  Host shapes only: ``lengths``
    stays on the device."""
    want = cdiv(PAGED_CTAS_PER_SM * sms, max(1, batch * kvh))
    pps = max(1, min(PAGED_WARPS, npb), cdiv(npb, want))
    return pps, max(1, cdiv(npb, pps))


def fit_splits(nblk: int, pps: int, nsplit: int,
               smem: Callable[[int, int], int], optin: int
               ) -> Tuple[int, int]:
    """Splits of twice the blocks, until one CTA's shared memory at one
    ring stage (``smem(pps, nsplit)``) fits ``optin`` bytes or one split
    is left: the split merge holds 2 x G floats a split, which outgrows
    a CTA at a large G and a long request (G 64 at D 128 over 32K
    tokens)."""
    while nsplit > 1 and smem(pps, nsplit) > optin:
        pps *= 2
        nsplit = cdiv(nblk, pps)
    return pps, nsplit


def _paged_depth(lib, rif: Optional[int], g: int, d: int, page: int,
                 pps: int, nsplit: int, bf16: bool, optin: int) -> int:
    """The ring depth of the split-KV decodes' warps: each of a CTA's
    ``PAGED_WARPS`` warps keeps ``depth`` K+V block stages, so
    ``PAGED_WARPS x depth`` blocks are in flight per CTA.  An explicit
    ``rif`` (requests in flight per CTA) gives ``max(1, rif //
    PAGED_WARPS)``; the default is the deepest of at most two stages
    that keeps ``PAGED_CTAS_PER_SM`` CTAs on an SM's shared memory (one
    at bf16 D 128 and 16-token pages: four CTAs then keep 16 K+V pages,
    128 KB, in flight per SM, where Little's law asks ~25 KB).  The
    depth is clamped to a warp's blocks of a split and, explicit or not,
    to a ``PAGED_CTAS_PER_SM``-th of the SM's shared memory, so a rif
    (a tuned one too) never changes how many CTAs an SM holds; a depth
    of one stays allowed where a stage alone exceeds that share."""
    def smem(depth):
        return lib.split_decode_smem(g, d, page, depth, pps, nsplit,
                                     int(bf16))
    if smem(1) > optin:
        raise ValueError(f"{PAGED_WARPS} block pairs of {page} x {d} do not "
                         f"fit {optin} bytes of shared memory")
    depth = 2 if rif is None else max(1, rif // PAGED_WARPS)
    depth = min(depth, cdiv(pps, PAGED_WARPS), MAX_RIF // PAGED_WARPS)
    while depth > 1 and smem(depth) > optin // PAGED_CTAS_PER_SM:
        depth -= 1
    return depth


# per (device, stream): B x KVH int32 counters the kernels leave at zero
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    key = (device.index, stream_ptr(device))
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return buf


def _split_args(lib, rif: Optional[int], q: torch.Tensor, nblk: int,
                block: int):
    """A split-KV decode's scratch and geometry for ``nblk`` blocks of
    ``block`` tokens per request: the partials (a tensor, or None with one
    split), the merge counters and ``(pps, nsplit, depth)``."""
    if rif is not None and not 1 <= rif <= MAX_RIF:
        raise ValueError(f"rif must be in [1, {MAX_RIF}], got {rif}")
    b, kvh, g, d = q.shape
    dev = q.device
    bf16 = q.dtype == torch.bfloat16
    optin = lib.repro_smem_optin(
        dev.index if dev.index is not None else torch.cuda.current_device())
    if optin <= 0:
        raise RuntimeError("could not read the card's shared-memory opt-in")
    pps, nsplit = fit_splits(
        nblk, *paged_splits(b, kvh, nblk, sm_count(dev)),
        lambda pps, nsplit: lib.split_decode_smem(g, d, block, 1, pps,
                                                  nsplit, int(bf16)), optin)
    depth = _paged_depth(lib, rif, g, d, block, pps, nsplit, bf16, optin)
    part = (torch.empty((b, kvh, nsplit, lib.split_decode_partial(g, d)),
                        dtype=torch.float32, device=dev)
            if nsplit > 1 else None)
    return part, _counters(dev, b * kvh), (pps, nsplit, depth)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


@counted
def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor, *, scale: float,
                       rif: Optional[int] = None) -> torch.Tensor:
    """q (B, KVH, G, D); pages (NP, KVH, PAGE, D); page_table (B, NPB)
    int32 of pool pages; lengths (B,) int32 >= 1 -> (B, KVH, G, D).
    ``rif`` is the pages in flight per CTA (:func:`_paged_depth`).  One
    launch per call: the splits of a (b, kv head) are merged by its last
    CTA.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
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
    out = torch.empty_like(q)
    if npb == 0:                     # no page: every row is masked
        return out.zero_()
    lib = _paged_lib()
    part, counters, split = _split_args(lib, rif, q, npb, page)
    status = launch(lib.flash_decode_paged, q.device,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), _ptr(part),
        counters.data_ptr(), b, kvh, g, d, npb, page, *split, scale,
        int(q.dtype == torch.bfloat16))
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
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
            ctypes.c_longlong
        lib.flash_prefill.argtypes = [p, p, p, p] + [i] * 8 + [f, i, i, i, p]
        lib.flash_prefill.restype = i
        lib.flash_prefill_block_keys.argtypes = [i, i, i]
        lib.flash_prefill_block_keys.restype = i
        lib.flash_prefill_stage_bytes.argtypes = [i, i, i]
        lib.flash_prefill_stage_bytes.restype = ll
        lib.flash_prefill_extra_bytes.argtypes = [i, i]
        lib.flash_prefill_extra_bytes.restype = ll
    return lib


def prefill_block_keys(lib, d: int, bf16: bool) -> Tuple[int, ...]:
    """The keys per ring stage ``flash`` takes at head dim ``d``, the
    default first (from the CUDA source's instantiations)."""
    return tuple(k for k in (lib.flash_prefill_block_keys(d, int(bf16), w)
                             for w in (0, 1)) if k)


@counted
def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool, window: Optional[int], scale: float,
          rif: Optional[int] = None, bk: Optional[int] = None
          ) -> torch.Tensor:
    """q (B, H, Sq, D); k, v (B, KVH, Sk, D) with H % KVH == 0 ->
    (B, H, Sq, D) in q's dtype.  Query row i sees key j < Sk with
    ``j <= i`` when causal and ``j >= i - window + 1`` when windowed.
    ``rif`` is the K/V ring's stages, ``bk`` the keys per stage (one of
    :func:`prefill_block_keys`; None takes the default).  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale)
    check_operands((q, k, v), copied=(q, k, v))
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
    bf16 = q.dtype == torch.bfloat16
    keys = prefill_block_keys(lib, d, bf16)
    bk = keys[0] if bk is None else bk
    if bk not in keys:
        raise ValueError(f"bk must be one of {keys} at D {d}, got {bk}")
    rif = ring_depth(lib, rif, lib.flash_prefill_stage_bytes(d, bk, bf16),
                     cdiv(sk, bk), q.device,
                     lib.flash_prefill_extra_bytes(d, bf16))
    status = launch(lib.flash_prefill, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kvh,
        sq, sk, d, int(causal), window or 0, scale, bk, rif, int(bf16))
    check_status(lib, status, "flash_prefill")
    flash.launches += 1
    return out
