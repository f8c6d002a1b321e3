"""Plain PyTorch oracles for attention: the port of
``repro.kernels.flash_attention.ref``: ``attention_ref`` (prefill), its
online-softmax and sliding-band variants ``attention_chunked`` and
``attention_banded`` (reached with ``attn_impl`` ``"chunked"`` or
``"banded"`` in ``ref`` mode), ``decode_ref`` and ``decode_chunk_ref``.

Every oracle groups the H query heads by KV head (head ``h`` reads KV
head ``h // G``), the pairing of JAX's head repetition, without
repeating K/V in memory."""

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


def _grouped(q: torch.Tensor, kvh: int) -> torch.Tensor:
    """(B, H, S, D) -> (B, KVH, G, S, D) in float32."""
    b, h, s, d = q.shape
    return q.float().reshape(b, kvh, h // kvh, s, d)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      scale: Optional[float] = None,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``chunk`` keys (the
    largest divisor of Sk not above it), so no (Sq, Sk) tensor is ever
    built: the schedule of the flash kernel in plain torch.  Shapes and
    masks as :func:`attention_ref`."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qf = _grouped(q, kvh) * scale
    chunk = min(chunk, sk)
    while sk % chunk:
        chunk -= 1
    rows = torch.arange(sq, device=q.device)[:, None]
    m = torch.full(qf.shape[:-1], NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for ki in range(sk // chunk):
        sl = slice(ki * chunk, (ki + 1) * chunk)
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, k[:, :, sl].float())
        cols = ki * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= cols <= rows
        if window is not None:
            mask &= cols >= rows - window + 1
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bksd->bkgqd", p, v[:, :, sl].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, sq, d).to(q.dtype)


def attention_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, causal: bool = True,
                     scale: Optional[float] = None,
                     chunk: int = 1024) -> torch.Tensor:
    """Sliding-window self-attention that touches only the band: query
    chunk [iC, iC + C) (C the largest divisor of S not above ``chunk``)
    reads the W + C keys [iC + C - W - C, iC + C), K/V left-padded by W,
    so the work is S (W + C) instead of S^2."""
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    chunk = min(chunk, sq)
    while sq % chunk:
        chunk -= 1
    band = window + chunk
    kp = torch.nn.functional.pad(k, (0, 0, band - chunk, 0))
    vp = torch.nn.functional.pad(v, (0, 0, band - chunk, 0))
    qf = _grouped(q, kvh) * scale
    outs = []
    for i in range(sq // chunk):
        start = i * chunk                      # padded start of the band
        qi = qf[:, :, :, start:start + chunk]
        s = torch.einsum("bkgqd,bksd->bkgqs", qi,
                         kp[:, :, start:start + band].float())
        rows = start + torch.arange(chunk, device=q.device)[:, None]
        cols = (start - (band - chunk)
                + torch.arange(band, device=q.device)[None, :])
        mask = (cols >= 0) & (cols >= rows - window + 1)
        if causal:
            mask = mask & (cols <= rows)
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        out = torch.einsum("bkgqs,bksd->bkgqd", p,
                           vp[:, :, start:start + band].float())
        outs.append(out / torch.clamp(p.sum(-1, keepdim=True), min=1e-30))
    out = torch.cat(outs, dim=3)
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
