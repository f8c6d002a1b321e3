"""Public wrappers for attention: the counterpart of
``repro.kernels.flash_attention.ops``.

``method="kernel"`` (JAX's ``"pallas"``) runs the Hopper kernels on CUDA
tensors and their plain versions on CPU tensors; ``method="ref"`` is the
oracle.  Knobs left ``None`` resolve explicit → tune cache → analytic,
keyed as the reference keys each op: ``flash_attention`` on (Sq, Sk, D),
``flash_decode`` on (S, D), ``flash_decode_paged`` on (page, D), with
q's dtype.  The analytic defaults: ``bk`` ``DEFAULT_BK`` and ``rif`` the
kernel wrapper's own (``plan_rif`` for the prefill, the split-KV
decodes' depth).  Unlike the TPU wrappers, nothing pads a cache or a
sequence to a multiple of the block: the kernels read only the rows that
exist.  The prefill kernel's query block is fixed in its CUDA source and
its key block is the source's default for the head dim, so
``flash_attention``'s ``bq``/``bk`` have no counterpart here: they are
accepted (positive ints, or ``None``) and ignored; its tuned knob is the
K/V ring depth ``rif``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import (check_ignored, refuse_autograd,
                                        tuned_knobs)
from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention.ref import attention_ref, decode_ref


def _method(method: str) -> str:
    if method not in ("kernel", "ref"):
        raise ValueError(f"unknown method {method!r}")
    return method


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    bq: Optional[int] = None, bk: Optional[int] = None,
                    rif: Optional[int] = None,
                    method: str = "kernel") -> torch.Tensor:
    """q (B,H,S,D); k,v (B,KVH,S,D) with H % KVH == 0 (GQA)."""
    check_ignored(bq=bq, bk=bk)
    if _method(method) == "ref":
        return attention_ref(q, k, v, causal=causal, window=window)
    refuse_autograd("flash_attention", q, k, v)
    if rif is None:
        rif = tuned_knobs("flash_attention", (q.shape[2], k.shape[2],
                                              q.shape[3]), q.dtype, q.device,
                          rif=(None, None))["rif"]
    return _k.flash(q.contiguous(), k.contiguous(), v.contiguous(),
                    causal=causal, window=window, scale=q.shape[3] ** -0.5,
                    rif=rif)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 bk: Optional[int] = None, rif: Optional[int] = None,
                 method: str = "kernel") -> torch.Tensor:
    """One-token decode: q (B,H,D) against caches (B,KVH,S,D)."""
    if _method(method) == "ref":
        return decode_ref(q, k_cache, v_cache, lengths)
    refuse_autograd("flash_decode", q, k_cache, v_cache)
    b, h, d = q.shape
    if bk is None or rif is None:
        knobs = tuned_knobs("flash_decode", (k_cache.shape[2], d), q.dtype,
                            q.device, bk=(bk, _k.DEFAULT_BK), rif=(rif, None))
        bk, rif = knobs["bk"], knobs["rif"]
    kvh = k_cache.shape[1]
    out = _k.flash_decode(q.reshape(b, kvh, h // kvh, d).contiguous(),
                          k_cache, v_cache,
                          lengths.to(torch.int32).contiguous(),
                          scale=d ** -0.5, bk=bk, rif=rif)
    return out.reshape(b, h, d)


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor, *, rif: Optional[int] = None,
                       method: str = "kernel") -> torch.Tensor:
    """Paged decode: pages (NP,KVH,PAGE,D), page_table (B, S/PAGE) int32."""
    b, h, d = q.shape
    if _method(method) == "ref":
        return decode_ref(q, _k.pages_to_cache(k_pages, page_table),
                          _k.pages_to_cache(v_pages, page_table), lengths)
    refuse_autograd("flash_decode_paged", q, k_pages, v_pages)
    if rif is None:
        rif = tuned_knobs("flash_decode_paged", (k_pages.shape[2], d),
                          q.dtype, q.device, rif=(None, None))["rif"]
    kvh = k_pages.shape[1]
    out = _k.flash_decode_paged(q.reshape(b, kvh, h // kvh, d).contiguous(),
                                k_pages, v_pages,
                                page_table.to(torch.int32).contiguous(),
                                lengths.to(torch.int32).contiguous(),
                                scale=d ** -0.5, rif=rif)
    return out.reshape(b, h, d)
