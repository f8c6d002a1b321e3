"""Self-attention, cache-free or with a contiguous or paged cache: the
counterpart of ``repro.models.attention``'s GQA and MLA.

Without a cache (``lm_apply``) the attention is ``_prefill_attention``:
the ``flash`` kernel in ``kernel`` mode; in ``ref`` mode
``attention_ref``, or its chunked or banded variant as ``attn_impl``
says.  Caches are updated IN PLACE (``index_put_`` into the per-layer
views of the cache tensors) where JAX builds new arrays; the values
written are the same, and serving's memory holds one cache, not two.
The returned cache is the same dict the caller passed.

MLA caches the compressed latent (``kv_lora_rank`` + ``qk_rope_dim``
values a token, paged or contiguous) and up-projects it to per-head K/V
at every step, as the reference does; its decode runs the contiguous
``flash_decode`` on that K and on V padded to K's head dim, on the
paged path too.  The encoder's bidirectional and the cross attention
wait for a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention.kernel import pages_to_cache
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_decode,
                                                     flash_decode_paged)
from repro_torch.kernels.flash_attention.ref import (attention_banded,
                                                     attention_chunked,
                                                     attention_ref,
                                                     decode_chunk_ref,
                                                     decode_ref)
from repro_torch.models.common import (ModelConfig, dense_param, norm_param,
                                       rmsnorm, rope)

Cache = Dict[str, torch.Tensor]


def _prefill_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, *, window: Optional[int]
                       ) -> torch.Tensor:
    """The cache-free causal attention: the ``flash`` kernel in
    ``kernel`` mode; else the banded, chunked or plain oracle as
    ``cfg.attn_impl`` says (banded only with a window)."""
    if cfg.kernel_mode == "kernel":
        return flash_attention(q, k, v, causal=True, window=window)
    if cfg.attn_impl == "banded" and window:
        return attention_banded(q, k, v, window=window, causal=True,
                                chunk=min(cfg.attn_chunk, window))
    if cfg.attn_impl in ("banded", "chunked"):
        return attention_chunked(q, k, v, causal=True, window=window,
                                 chunk=cfg.attn_chunk)
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


def _chunk_slots(pos: torch.Tensor, valid: torch.Tensor, smax: int):
    """Where a chunk lands in a contiguous cache, computed on the device
    (no host sync): row b rewrites the ``w = min(C, Smax)`` consecutive
    slots from ``clamp(pos_b, 0, Smax - w)``, which hold every in-range
    target ``pos_b + i``.  Slot j takes chunk token ``j - pos_b`` where
    that lies in [0, C) and the token is valid, else its own value, so
    each row writes w distinct slots and no two writes of one call
    collide.  Returns the row index (B, 1), the slots (B, w), the token
    of each slot (B, w) and whether the slot takes it (B, w)."""
    b, c = valid.shape
    w = min(c, smax)
    ar = torch.arange(w, device=pos.device)
    slots = torch.clamp(pos.long(), 0, smax - w)[:, None] + ar[None, :]
    tok = slots - pos.long()[:, None]                       # <= C - 1
    tok_c = torch.clamp(tok, min=0)
    take = (tok >= 0) & torch.gather(valid, 1, tok_c)
    rows = torch.arange(b, device=pos.device)[:, None]
    return rows, slots, tok_c, take


def _scatter_token(cache: torch.Tensor, new: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """cache (B, KVH, Smax, hd); new (B, KVH, 1, hd); pos (B,).  Rows
    whose position lies outside the cache write nothing."""
    ones = torch.ones((pos.shape[0], 1), dtype=torch.bool, device=pos.device)
    return _scatter_heads(cache, new, pos, ones)


def _scatter_heads(cache: torch.Tensor, new: torch.Tensor,
                   pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """cache (B, KVH, Smax, hd) rewritten in place at :func:`_chunk_slots`
    from new (B, KVH, C, hd)."""
    rows, slots, tok, take = _chunk_slots(pos, valid, cache.shape[2])
    cur = cache[rows, :, slots]                          # (B, w, KVH, hd)
    upd = new.transpose(1, 2)[rows, tok].to(cache.dtype)
    cache[rows, :, slots] = torch.where(take[..., None, None], upd, cur)
    return cache


def _scatter_chunk(k_cache: torch.Tensor, v_cache: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   pos: torch.Tensor, valid: torch.Tensor):
    """caches (B, KVH, Smax, hd); new (B, KVH, C, hd); pos (B,);
    valid (B, C).  Chunk token i of row b lands at position pos_b + i;
    invalid tokens (and targets past Smax) write nothing."""
    return (_scatter_heads(k_cache, k_new, pos, valid),
            _scatter_heads(v_cache, v_new, pos, valid))


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


def _scatter_vec_pages(pages: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor, valid: torch.Tensor,
                       page_table: torch.Tensor) -> torch.Tensor:
    """pages (NP, PAGE, D); new (B, C, D): the MLA latent variant of
    :func:`_scatter_chunk_pages`."""
    page = pages.shape[1]
    blk, off = _page_targets(page, page_table.shape[1], pos, valid)
    pg = torch.where(valid, torch.gather(page_table, 1, blk.long()), 0)
    pages[pg.reshape(-1).long(), off.reshape(-1).long()] = \
        new.reshape(-1, new.shape[-1]).to(pages.dtype)
    return pages


def _gather_vec_pages(pages: torch.Tensor, page_table: torch.Tensor
                      ) -> torch.Tensor:
    """(NP, PAGE, D), (B, NPB) -> contiguous (B, NPB*PAGE, D)."""
    g = pages[page_table.long()]                  # (B, NPB, PAGE, D)
    b, npb, page, d = g.shape
    return g.reshape(b, npb * page, d)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 / MiniCPM3 multi-head latent attention)
# ---------------------------------------------------------------------------


class MLAttention(nn.Module):
    """``mla_init``'s leaves in its layout: the latent down-projection
    ``w_dkv`` (d, r) and its RMSNorm gain ``kv_norm`` (r,), the up-
    projections ``w_uk`` (r, H*dn) and ``w_uv`` (r, H*dv), the shared
    rope key ``w_kr`` (d, dr), ``wo`` (H*dv, d), and the query: ``w_dq``
    (d, q_lora_rank), ``q_norm`` (q_lora_rank,) and ``w_uq``
    (q_lora_rank, H*(dn+dr)) with a query rank, else ``wq`` (d,
    H*(dn+dr))."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, h, dt = cfg.d_model, cfg.n_heads, cfg.adtype
        dn, dr, dv = cfg.qk_nope, cfg.qk_rope_dim, cfg.v_hd
        r = cfg.kv_lora_rank
        self.w_dkv = dense_param((d, r), dt, device, generator)
        self.kv_norm = norm_param(r, device)
        self.w_uk = dense_param((r, h * dn), dt, device, generator)
        self.w_uv = dense_param((r, h * dv), dt, device, generator)
        self.w_kr = dense_param((d, dr), dt, device, generator)
        self.wo = dense_param((h * dv, d), dt, device, generator)
        if cfg.q_lora_rank:
            self.w_dq = dense_param((d, cfg.q_lora_rank), dt, device,
                                    generator)
            self.q_norm = norm_param(cfg.q_lora_rank, device)
            self.w_uq = dense_param((cfg.q_lora_rank, h * (dn + dr)), dt,
                                    device, generator)
        else:
            self.wq = dense_param((d, h * (dn + dr)), dt, device, generator)


def _mla_q(cfg: ModelConfig, p: MLAttention, x: torch.Tensor):
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = rmsnorm(x @ p.w_dq, p.q_norm, cfg.norm_eps) @ p.w_uq
    else:
        q = x @ p.wq
    q = q.reshape(b, s, h, dn + dr)
    return q[..., :dn], q[..., dn:]     # nope (B,S,H,dn), rope (B,S,H,dr)


def v_pad_to(v: torch.Tensor, d: int) -> torch.Tensor:
    """Pad the value head dim with zeros to ``d`` (K's head dim), so one
    attention kernel takes K and V."""
    if v.shape[-1] == d:
        return v
    return torch.nn.functional.pad(v, (0, d - v.shape[-1]))


def mla_apply(cfg: ModelConfig, p: MLAttention, x: torch.Tensor,
              positions: torch.Tensor, *, cache: Optional[Cache] = None,
              valid: Optional[torch.Tensor] = None,
              page_table: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """MLA attention.  cache = {"ckv": (B,Smax,r), "kr": (B,Smax,dr),
    "len": (B,)}, the compressed-latent cache, or the paged layout
    {"ckvp": (NP,PAGE,r), "krp": (NP,PAGE,dr), "len": (B,)} with a
    ``page_table`` (B, NPB): the latents are paged, gathered back to a
    contiguous (B, NPB*PAGE, ·) view and up-projected as on the
    contiguous path, and the paged step always takes the masked-chunk
    branch (so a paged decode runs the contiguous ``flash_decode``).
    S > 1 (or an explicit ``valid`` mask) with a cache is the chunked
    cache-fill path of :func:`gqa_apply`.  Caches are written in place
    and ``len`` is set last."""
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope, cfg.qk_rope_dim, cfg.v_hd
    dt = cfg.adtype

    q_nope, q_rope = _mla_q(cfg, p, x)
    q_rope = rope(q_rope.transpose(1, 2), positions[:, None, :],
                  cfg.rope_theta)                               # (B,H,S,dr)
    q_nope = q_nope.transpose(1, 2)                             # (B,H,S,dn)

    ckv = rmsnorm(x @ p.w_dkv, p.kv_norm, cfg.norm_eps)         # (B,S,r)
    kr = rope((x @ p.w_kr)[:, None], positions[:, None, :],
              cfg.rope_theta)                                   # (B,1,S,dr)

    # paged decode always takes the masked-chunk path
    paged = cache is not None and "ckvp" in cache
    chunked = paged or (cache is not None and not (s == 1 and valid is None))
    if chunked and valid is None:
        valid = torch.ones((b, s), dtype=torch.bool, device=x.device)
    pos = None if cache is None else cache["len"]              # (B,)
    if cache is None:
        ckv_full, kr_full = ckv, kr
    elif paged:
        if page_table is None:
            raise ValueError("paged MLA cache requires a page_table")
        _scatter_vec_pages(cache["ckvp"], ckv, pos, valid, page_table)
        _scatter_vec_pages(cache["krp"], kr[:, 0], pos, valid, page_table)
        lens = pos + valid.sum(-1).to(pos.dtype)
        ckv_full = _gather_vec_pages(cache["ckvp"], page_table)  # (B,Slog,r)
        kr_full = _gather_vec_pages(cache["krp"], page_table)[:, None]
    elif not chunked:
        _scatter_vec(cache["ckv"], ckv, pos)
        _scatter_vec(cache["kr"], kr[:, 0], pos)
        lens = pos + 1
        ckv_full, kr_full = cache["ckv"], cache["kr"][:, None]
    else:
        _scatter_vec_chunk(cache["ckv"], ckv, pos, valid)
        _scatter_vec_chunk(cache["kr"], kr[:, 0], pos, valid)
        lens = pos + valid.sum(-1).to(pos.dtype)
        ckv_full, kr_full = cache["ckv"], cache["kr"][:, None]
    s_kv = ckv_full.shape[1]

    # up-project the latents to per-head K/V (decode recomputes them from
    # the latents: the decoupled fetch reads only r + dr values a token)
    k_nope = (ckv_full @ p.w_uk).reshape(b, s_kv, h, dn).transpose(1, 2)
    v = (ckv_full @ p.w_uv).reshape(b, s_kv, h, dv).transpose(1, 2)
    k = torch.cat([k_nope, kr_full.expand(b, h, s_kv, dr).to(dt)], -1)
    qk = torch.cat([q_nope, q_rope], -1)                        # (B,H,S,dn+dr)
    v = v_pad_to(v, k.shape[-1])

    if cache is None:
        out = _prefill_attention(cfg, qk, k, v, window=None)[..., :dv]
    else:
        kernel = cfg.kernel_mode == "kernel"
        if chunked:
            steps = torch.arange(1, s + 1, dtype=pos.dtype, device=pos.device)
            qlens = pos[:, None] + steps[None]                  # (B, S)
            if s == 1 and kernel:
                out = flash_decode(qk[:, :, 0, :], k, v,
                                   qlens[:, 0])[..., :dv][:, :, None, :]
            else:
                out = decode_chunk_ref(qk, k, v, qlens)[..., :dv]
        else:
            qd = qk[:, :, 0, :]
            out = (flash_decode(qd, k, v, lens) if kernel
                   else decode_ref(qd, k, v, lens))[..., :dv][:, :, None, :]
        cache["len"].copy_(lens)  # after every read of pos (a view of it)

    out = out.transpose(1, 2).reshape(b, s, h * dv)
    return out @ p.wo, cache


def _scatter_vec(cache: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """cache (B, Smax, D); new (B, 1, D); pos (B,).  Rows whose position
    lies outside the cache write nothing."""
    ones = torch.ones((pos.shape[0], 1), dtype=torch.bool, device=pos.device)
    return _scatter_vec_chunk(cache, new, pos, ones)


def _scatter_vec_chunk(cache: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor, valid: torch.Tensor
                       ) -> torch.Tensor:
    """cache (B, Smax, D); new (B, C, D); pos (B,); valid (B, C).  Chunk
    token i of row b lands at position pos_b + i; invalid tokens (and
    targets past Smax) write nothing (:func:`_chunk_slots`)."""
    rows, slots, tok, take = _chunk_slots(pos, valid, cache.shape[1])
    cur = cache[rows, slots]                                 # (B, w, D)
    upd = new[rows, tok].to(cache.dtype)
    cache[rows, slots] = torch.where(take[..., None], upd, cur)
    return cache
