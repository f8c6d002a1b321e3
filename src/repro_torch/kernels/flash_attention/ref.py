"""Plain PyTorch oracles for attention: the port of
``repro.kernels.flash_attention.ref``'s ``attention_ref`` (prefill),
``decode_ref`` and ``decode_chunk_ref``.  ``attention_chunked`` and
``attention_banded`` (reached only with ``attn_impl != "ref"``) are not
ported yet."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,Sq,D); k,v (B,KVH,Sk,D); head ``h`` reads KV head ``h // G``
    (JAX's head repetition), without repeating K/V in memory.  Query row
    i sees key j where ``j <= i`` (causal) and ``j >= i - window + 1``."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(b, kvh, g, sq, d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * scale
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols >= rows - window + 1
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)


def decode_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               lengths: torch.Tensor, *,
               scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,D); caches (B,KVH,S,D); lengths (B,) valid prefix lengths.

    GQA groups the H query heads by KV head (head ``h`` reads KV head
    ``h // G``), the same pairing as JAX's head repetition."""
    b, h, d = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(b, kvh, g, d)
    logits = torch.einsum("bkgd,bksd->bkgs", qf, k_cache.float()) * scale
    mask = (torch.arange(s, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])                   # (B, S)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def decode_chunk_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Multi-query decode against a KV cache: the chunked-prefill oracle.

    q (B,H,C,D) — C new queries per batch row; caches (B,KVH,S,D);
    lengths (B,C) — query i of row b attends cache positions
    < lengths[b, i].

    Deliberately a sequential loop of :func:`decode_ref` over the C
    queries rather than one (C, S) product: the accumulation order of a
    matrix product depends on its shape, and serving keeps chunked
    prefill BIT-identical to a run of single-token decode steps.  The
    caches are widened to float32 once, outside the loop, which
    ``decode_ref`` would otherwise repeat per query; the values are the
    same."""
    kf, vf = k_cache.float(), v_cache.float()
    outs = [decode_ref(q[:, :, i], kf, vf, lengths[:, i], scale=scale)
            for i in range(q.shape[2])]
    return torch.stack(outs, dim=2)                            # (B,H,C,D)
