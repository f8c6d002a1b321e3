"""GQA attention, cache-free or with a contiguous or paged KV cache: the
counterpart of the GQA half of ``repro.models.attention``.

Without a cache (``lm_apply``) the attention is ``_prefill_attention``:
the ``flash`` kernel in ``kernel`` mode, ``attention_ref`` in ``ref``
mode.  Caches are updated IN PLACE (``index_put_`` into the per-layer
views of the cache tensors) where JAX builds new arrays; the values
written are the same, and serving's memory holds one cache, not two.
The returned cache is the same dict the caller passed.  MLA waits for a
later slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention.kernel import pages_to_cache
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_decode,
                                                     flash_decode_paged)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     decode_chunk_ref,
                                                     decode_ref)
from repro_torch.models.common import (ModelConfig, dense_param, norm_param,
                                       rmsnorm, rope)

Cache = Dict[str, torch.Tensor]


def _prefill_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, *, window: Optional[int]
                       ) -> torch.Tensor:
    """The cache-free causal attention: the ``flash`` kernel, or the
    oracle.  (JAX's ``attn_impl`` chunked and banded variants, and the
    encoder's bidirectional attention, are not ported.)"""
    if cfg.kernel_mode == "kernel":
        return flash_attention(q, k, v, causal=True, window=window)
    return attention_ref(q, k, v, causal=True, window=window)


class GQAttention(nn.Module):
    """Weights ``wq`` (d, H*hd), ``wk``/``wv`` (d, KVH*hd), ``wo``
    (H*hd, d) in ``cfg.dtype``; optional q/k RMSNorm gains."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hd, h, kvh, d, dt = (cfg.hd, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_model, cfg.adtype)
        self.wq = dense_param((d, h * hd), dt, device, generator)
        self.wk = dense_param((d, kvh * hd), dt, device, generator)
        self.wv = dense_param((d, kvh * hd), dt, device, generator)
        self.wo = dense_param((h * hd, d), dt, device, generator)
        if cfg.qk_norm:
            self.q_norm = norm_param(hd, device)
            self.k_norm = norm_param(hd, device)


def _project_qkv(cfg: ModelConfig, p: GQAttention, x: torch.Tensor,
                 positions: torch.Tensor):
    b, s, d = x.shape
    hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    q = rope(q.transpose(1, 2), positions[:, None, :], cfg.rope_theta)
    k = rope(k.transpose(1, 2), positions[:, None, :], cfg.rope_theta)
    v = v.transpose(1, 2)
    return q, k, v      # (B, H, S, hd), (B, KVH, S, hd) x2


def gqa_apply(cfg: ModelConfig, p: GQAttention, x: torch.Tensor,
              positions: torch.Tensor, *, window: Optional[int] = None,
              cache: Optional[Cache] = None,
              valid: Optional[torch.Tensor] = None,
              page_table: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Cache-free causal attention when ``cache`` is None (``window``
    applies there); otherwise decode / chunked cache-fill attention that
    updates ``cache`` in place.

    cache = {"k": (B,KVH,Smax,hd), "v": ..., "len": (B,) int32}
      or the paged layout
    cache = {"kp": (NP,KVH,PAGE,hd), "vp": ..., "len": (B,) int32}
    with ``page_table`` (B, NPB) int32 mapping each row's logical block
    to a pool page; invalid-token writes land in the trash page 0.

    With S > 1 (or an explicit ``valid`` (B, S) mask) the S new tokens of
    each row land at its ``len``-onward positions, query i attends the
    prefix through position len+i, and rows with 0 valid tokens keep
    cache and length.  In ``kernel`` mode a single-token step runs the
    paged or contiguous decode kernel; chunks go through the gathered
    contiguous view and ``decode_chunk_ref`` (plain torch on the card,
    as it is plain XLA in JAX).
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions)
    if cache is None:
        out = _prefill_attention(cfg, q, k, v, window=window)
        out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
        return out @ p.wo, None
    kernel = cfg.kernel_mode == "kernel"
    pos = cache["len"]                                         # (B,)
    steps = torch.arange(1, s + 1, dtype=pos.dtype, device=pos.device)
    qlens = pos[:, None] + steps[None]                         # (B, S)

    if "kp" in cache:
        if page_table is None:
            raise ValueError("paged KV cache requires a page_table")
        if valid is None:
            valid = torch.ones((b, s), dtype=torch.bool, device=x.device)
        kp = _scatter_chunk_pages(cache["kp"], k, pos, valid, page_table)
        vp = _scatter_chunk_pages(cache["vp"], v, pos, valid, page_table)
        lens = pos + valid.sum(-1).to(pos.dtype)
        if s == 1 and kernel:
            out = flash_decode_paged(q[:, :, 0, :], kp, vp, page_table,
                                     qlens[:, 0])[:, :, None, :]
        else:
            out = decode_chunk_ref(q, pages_to_cache(kp, page_table),
                                   pages_to_cache(vp, page_table), qlens)
    elif s == 1 and valid is None:
        kc = _scatter_token(cache["k"], k, pos)
        vc = _scatter_token(cache["v"], v, pos)
        lens = pos + 1
        qd = q[:, :, 0, :]                                     # (B,H,hd)
        out = (flash_decode(qd, kc, vc, lens) if kernel
               else decode_ref(qd, kc, vc, lens))[:, :, None, :]
    else:
        if valid is None:
            valid = torch.ones((b, s), dtype=torch.bool, device=x.device)
        kc, vc = _scatter_chunk(cache["k"], cache["v"], k, v, pos, valid)
        lens = pos + valid.sum(-1).to(pos.dtype)
        if s == 1 and kernel:
            # masked decode keeps the decode kernel (masked rows produce
            # values the caller never reads)
            out = flash_decode(q[:, :, 0, :], kc, vc,
                               qlens[:, 0])[:, :, None, :]
        else:
            out = decode_chunk_ref(q, kc, vc, qlens)           # (B,H,S,hd)
    cache["len"].copy_(lens)     # after every read of pos (a view of it)

    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    return out @ p.wo, cache


def _scatter_token(cache: torch.Tensor, new: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """cache (B, KVH, Smax, hd); new (B, KVH, 1, hd); pos (B,).  Rows
    whose position lies outside the cache write nothing."""
    rows = torch.nonzero(pos < cache.shape[2]).flatten()
    cache[rows, :, pos[rows].long(), :] = new[rows, :, 0, :].to(cache.dtype)
    return cache


def _scatter_chunk(k_cache: torch.Tensor, v_cache: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   pos: torch.Tensor, valid: torch.Tensor):
    """caches (B, KVH, Smax, hd); new (B, KVH, C, hd); pos (B,);
    valid (B, C).  Chunk token i of row b lands at position pos_b + i;
    invalid tokens (and targets past Smax) write nothing."""
    smax, c = k_cache.shape[2], k_new.shape[2]
    tgt = pos[:, None] + torch.arange(c, dtype=pos.dtype,
                                      device=pos.device)[None, :]  # (B, C)
    bi, ci = torch.nonzero(valid & (tgt < smax), as_tuple=True)
    ti = tgt[bi, ci].long()
    k_cache[bi, :, ti, :] = k_new[bi, :, ci, :].to(k_cache.dtype)
    v_cache[bi, :, ti, :] = v_new[bi, :, ci, :].to(v_cache.dtype)
    return k_cache, v_cache


# paged KV helpers ------------------------------------------------------------


def _page_targets(page: int, npb: int, pos: torch.Tensor,
                  valid: torch.Tensor):
    """Logical block + offset of each of the C new tokens per row (the
    caller resolves the page id and reroutes invalid tokens to page 0)."""
    c = valid.shape[1]
    tgt = pos[:, None] + torch.arange(c, dtype=pos.dtype,
                                      device=pos.device)[None, :]  # (B, C)
    blk = torch.clamp(tgt // page, 0, npb - 1)
    return blk, tgt % page


def _scatter_chunk_pages(pages: torch.Tensor, new: torch.Tensor,
                         pos: torch.Tensor, valid: torch.Tensor,
                         page_table: torch.Tensor) -> torch.Tensor:
    """pages (NP, KVH, PAGE, hd); new (B, KVH, C, hd); pos (B,);
    valid (B, C); page_table (B, NPB) int32.  Valid token i of row b
    lands at offset (pos_b + i) % PAGE of page
    table[b, (pos_b + i) // PAGE]; invalid tokens land in page 0 (several
    may hit one slot there; its contents are never attended)."""
    page = pages.shape[2]
    kvh, hd = pages.shape[1], pages.shape[3]
    blk, off = _page_targets(page, page_table.shape[1], pos, valid)
    pg = torch.where(valid, torch.gather(page_table, 1, blk.long()), 0)
    vals = new.transpose(1, 2).reshape(-1, kvh, hd)           # (B*C, KVH, hd)
    pages[pg.reshape(-1).long(), :, off.reshape(-1).long(), :] = \
        vals.to(pages.dtype)
    return pages
