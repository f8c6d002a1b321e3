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
paged path too.

In a sharded step (``parallel/sharding.py::step_shards``) GQA runs on
the rank's heads (:class:`Heads`): q/k/v and their biases are
column-parallel, ``wo`` row-parallel and followed by a psum over
``model``.  Where the model cut splits a head, the projection's column
shards are all-gathered (activations, not weights) and each rank keeps
the heads its slice of ``wo`` reads and the KV heads those need.  The
cache keeps JAX's layout, whole over ``model``: every rank writes every
KV head and attends its own through a view of the cache.

The encoder-decoder's attention is here too: the encoder's
bidirectional self-attention (``gqa_apply`` with ``causal=False``) and
the decoder's cross attention (``cross_kv`` projects the encoder output
to K/V, ``cross_attn_apply`` attends it without a mask and without
RoPE), both through ``_prefill_attention``: the ``flash`` kernel with
``causal=False`` in ``kernel`` mode, at ``Sq`` != ``Sk``.
"""

from __future__ import annotations

import dataclasses
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
                                       rmsnorm, rope, vector_param)
from repro_torch.parallel.sharding import (gather_pool, gather_seq,
                                           keep_seq, keep_shard, model_cut,
                                           tp_enter, tp_gather, tp_leave,
                                           use)

Cache = Dict[str, torch.Tensor]


def _prefill_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, *, window: Optional[int],
                       causal: bool = True) -> torch.Tensor:
    """The cache-free attention, causal or bidirectional: the ``flash``
    kernel in ``kernel`` mode; else the banded, chunked or plain oracle
    as ``cfg.attn_impl`` says (banded only causal with a window)."""
    if cfg.kernel_mode == "kernel":
        return flash_attention(q, k, v, causal=causal, window=window)
    if cfg.attn_impl == "banded" and window and causal:
        return attention_banded(q, k, v, window=window, causal=True,
                                chunk=min(cfg.attn_chunk, window))
    if cfg.attn_impl in ("banded", "chunked"):
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 chunk=cfg.attn_chunk)
    return attention_ref(q, k, v, causal=causal, window=window)


class GQAttention(nn.Module):
    """Weights ``wq`` (d, H*hd), ``wk``/``wv`` (d, KVH*hd), ``wo``
    (H*hd, d) stored in ``dtype`` (default ``cfg.dtype``); with
    ``cfg.qkv_bias`` the float32 biases ``bq`` (H*hd,), ``bk``/``bv``
    (KVH*hd,), zero as JAX initialises them; optional q/k RMSNorm
    gains."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        hd, h, kvh, d, dt = (cfg.hd, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_model, dtype or cfg.adtype)
        self.wq = dense_param((d, h * hd), dt, device, generator)
        self.wk = dense_param((d, kvh * hd), dt, device, generator)
        self.wv = dense_param((d, kvh * hd), dt, device, generator)
        self.wo = dense_param((h * hd, d), dt, device, generator)
        if cfg.qkv_bias:
            self.bq = vector_param(torch.zeros(h * hd, device=device))
            self.bk = vector_param(torch.zeros(kvh * hd, device=device))
            self.bv = vector_param(torch.zeros(kvh * hd, device=device))
        if cfg.qk_norm:
            self.q_norm = norm_param(hd, device)
            self.k_norm = norm_param(hd, device)


@dataclasses.dataclass(frozen=True)
class Heads:
    """The heads one rank attends in a sharded step: the columns
    ``[c0, c1)`` of the attention output its rows of ``wo`` read, the
    query heads ``[h0, h1)`` that hold them and the KV heads ``[kv0,
    kv1)`` those query heads read; ``split`` False when ``model`` does
    not cut the layer (every rank computes all of it)."""

    c0: int
    c1: int
    h0: int
    h1: int
    kv0: int
    kv1: int
    split: bool


def heads(cfg: ModelConfig, p: GQAttention) -> Heads:
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cut = model_cut(p.wo)
    if cut is None:
        return Heads(0, h * hd, 0, h, 0, kvh, False)
    _, n, j = cut
    w = h * hd // n
    c0, c1 = j * w, (j + 1) * w
    h0, h1 = c0 // hd, -(-c1 // hd)
    g = h // kvh
    kv0, kv1 = h0 // g, (h1 - 1) // g + 1
    if kv1 - kv0 > 1 and (h0 % g or (h1 - h0) % g):
        raise NotImplementedError(
            f"{n} model slots give a rank query heads {h0}..{h1 - 1}, which "
            f"do not fill whole groups of {g} over several KV heads")
    return Heads(c0, c1, h0, h1, kv0, kv1, True)


def _cols(w: torch.Tensor, y: torch.Tensor, lo: int, hi: int,
          total: int) -> torch.Tensor:
    """Columns ``[lo, hi)`` of the ``total`` a projection outputs, from
    this rank's ``y = x @ w`` (``w`` column-cut over ``model``, or
    whole): ``y`` itself when its shard is those columns, else the
    shards gathered over ``model`` and sliced."""
    cut = model_cut(w)
    if cut is not None:
        _, n, j = cut
        if (lo, hi) == (j * total // n, (j + 1) * total // n):
            return y
        y = tp_gather(y)
    return y if (lo, hi) == (0, total) else y[..., lo:hi]


def _project_qkv(cfg: ModelConfig, p: GQAttention, x: torch.Tensor,
                 positions: torch.Tensor, hs: Heads,
                 all_kv: bool = False):
    """q of this rank's query heads, k and v of its KV heads (of every
    KV head when ``all_kv``: a cache is whole over ``model``)."""
    b, s, d = x.shape
    hd, dt = cfg.hd, cfg.adtype
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    if hs.split:                     # f: x enters model-local compute
        x = tp_enter(x)
    q = x @ use(p.wq).to(dt)
    k = x @ use(p.wk).to(dt)
    v = x @ use(p.wv).to(dt)
    if cfg.qkv_bias:
        q = q + use(p.bq).to(dt)
        k = k + use(p.bk).to(dt)
        v = v + use(p.bv).to(dt)
    kv0, kv1 = (0, kvh) if all_kv else (hs.kv0, hs.kv1)
    q = _cols(p.wq, q, hs.h0 * hd, hs.h1 * hd, h * hd)
    k = _cols(p.wk, k, kv0 * hd, kv1 * hd, kvh * hd)
    v = _cols(p.wv, v, kv0 * hd, kv1 * hd, kvh * hd)
    q = q.reshape(b, s, hs.h1 - hs.h0, hd)
    k = k.reshape(b, s, kv1 - kv0, hd)
    v = v.reshape(b, s, kv1 - kv0, hd)
    if cfg.qk_norm:
        # replicated gains on this rank's heads: f sums their gradients
        qn, kn = ((tp_enter(p.q_norm), tp_enter(p.k_norm)) if hs.split
                  else (p.q_norm, p.k_norm))
        q = rmsnorm(q, qn, cfg.norm_eps)
        k = rmsnorm(k, kn, cfg.norm_eps)
    q = rope(q.transpose(1, 2), positions[:, None, :], cfg.rope_theta)
    k = rope(k.transpose(1, 2), positions[:, None, :], cfg.rope_theta)
    v = v.transpose(1, 2)
    return q, k, v      # (B, H', S, hd), (B, KVH', S, hd) x2


def _out_proj(cfg: ModelConfig, p: GQAttention, hs: Heads,
              out: torch.Tensor) -> torch.Tensor:
    """out (B, H', S, hd) of this rank's query heads -> its columns
    through its rows of ``wo``, summed over ``model`` (g)."""
    b, _, s, hd = out.shape
    out = out.transpose(1, 2).reshape(b, s, -1)
    lo = hs.c0 - hs.h0 * hd
    if (lo, hs.c1 - hs.h0 * hd) != (0, out.shape[-1]):
        out = out[..., lo:hs.c1 - hs.h0 * hd]
    y = out @ use(p.wo).to(cfg.adtype)
    return tp_leave(y) if hs.split else y


def gqa_apply(cfg: ModelConfig, p: GQAttention, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None,
              cache: Optional[Cache] = None,
              valid: Optional[torch.Tensor] = None,
              page_table: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Cache-free attention when ``cache`` is None (``causal`` and
    ``window`` apply there: the encoder passes ``causal=False``);
    otherwise decode / chunked cache-fill attention that updates
    ``cache`` in place.

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
    hs = heads(cfg, p)
    q, k, v = _project_qkv(cfg, p, x, positions, hs,
                           all_kv=cache is not None)
    if cache is None:
        out = _prefill_attention(cfg, q, k, v, causal=causal, window=window)
        return _out_proj(cfg, p, hs, out), None
    if hs.split and "kp" in cache:
        raise NotImplementedError("a paged cache under tensor parallelism")
    kernel = cfg.kernel_mode == "kernel"
    pos = cache["len"]                                         # (B,)
    steps = torch.arange(1, s + 1, dtype=pos.dtype, device=pos.device)
    qlens = pos[:, None] + steps[None]                         # (B, S)

    if "kp" in cache:
        if page_table is None:
            raise ValueError("paged KV cache requires a page_table")
        if valid is None:
            valid = torch.ones((b, s), dtype=torch.bool, device=x.device)
        # a pool sharded over ranks is gathered whole, written and
        # attended as on one device, and each rank keeps its slice
        kp = _scatter_chunk_pages(gather_pool(cfg, cache["kp"]), k, pos,
                                  valid, page_table)
        vp = _scatter_chunk_pages(gather_pool(cfg, cache["vp"]), v, pos,
                                  valid, page_table)
        keep_shard(cfg, cache["kp"], kp)
        keep_shard(cfg, cache["vp"], vp)
        lens = pos + valid.sum(-1).to(pos.dtype)
        if s == 1 and kernel:
            out = flash_decode_paged(q[:, :, 0, :], kp, vp, page_table,
                                     qlens[:, 0])[:, :, None, :]
        else:
            out = decode_chunk_ref(q, pages_to_cache(kp, page_table),
                                   pages_to_cache(vp, page_table), qlens)
    elif s == 1 and valid is None:
        # a cache cut on its sequence is gathered whole, written and
        # attended, and each rank keeps its slice
        kc = _scatter_token(gather_seq(cache["k"], 2), k, pos)
        vc = _scatter_token(gather_seq(cache["v"], 2), v, pos)
        keep_seq(cache["k"], kc, 2)
        keep_seq(cache["v"], vc, 2)
        lens = pos + 1
        qd = q[:, :, 0, :]                                     # (B,H,hd)
        kc, vc = kc[:, hs.kv0:hs.kv1], vc[:, hs.kv0:hs.kv1]   # its heads
        out = (flash_decode(qd, kc, vc, lens) if kernel
               else decode_ref(qd, kc, vc, lens))[:, :, None, :]
    else:
        if valid is None:
            valid = torch.ones((b, s), dtype=torch.bool, device=x.device)
        kc, vc = _scatter_chunk(gather_seq(cache["k"], 2),
                                gather_seq(cache["v"], 2), k, v, pos, valid)
        keep_seq(cache["k"], kc, 2)
        keep_seq(cache["v"], vc, 2)
        lens = pos + valid.sum(-1).to(pos.dtype)
        kc, vc = kc[:, hs.kv0:hs.kv1], vc[:, hs.kv0:hs.kv1]
        if s == 1 and kernel:
            # masked decode keeps the decode kernel (masked rows produce
            # values the caller never reads)
            out = flash_decode(q[:, :, 0, :], kc, vc,
                               qlens[:, 0])[:, :, None, :]
        else:
            out = decode_chunk_ref(q, kc, vc, qlens)           # (B,H,S,hd)
    cache["len"].copy_(lens)     # after every read of pos (a view of it)
    return _out_proj(cfg, p, hs, out), cache


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


# cross attention (encoder-decoder) -------------------------------------------


def cross_attn_apply(cfg: ModelConfig, p: GQAttention, x: torch.Tensor,
                     enc_kv: Tuple[torch.Tensor, torch.Tensor],
                     per_query: bool = False) -> torch.Tensor:
    """x (B, S, D) queries against the encoder's precomputed ``enc_kv``
    (k, v), each (B, KVH, S_enc, hd): no mask, no RoPE.  ``per_query``
    (serving's chunked cache fill) attends the S queries one at a time at
    S = 1 shapes, one ``_prefill_attention`` call each, as JAX's
    ``lax.map`` does, so a chunk computes what S single-token decode
    steps compute."""
    b, s, _ = x.shape
    hd, h, dt = cfg.hd, cfg.n_heads, cfg.adtype
    q = x @ p.wq.to(dt)
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
    q = q.reshape(b, s, h, hd).transpose(1, 2)                 # (B,H,S,hd)
    k, v = enc_kv
    if per_query:
        out = torch.cat([_prefill_attention(cfg, q[:, :, i:i + 1], k, v,
                                            causal=False, window=None)
                         for i in range(s)], dim=2)
    else:
        out = _prefill_attention(cfg, q, k, v, causal=False, window=None)
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return out @ p.wo.to(dt)


def cross_kv(cfg: ModelConfig, p: GQAttention, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross attention's K and V, (B, KVH, S_enc, hd) each, from the
    encoder output (B, S_enc, D); recomputed at every step and layer, as
    the reference does."""
    b, se, _ = enc_out.shape
    kvh, hd, dt = cfg.n_kv_heads, cfg.hd, cfg.adtype
    k = enc_out @ p.wk.to(dt)
    v = enc_out @ p.wv.to(dt)
    if cfg.qkv_bias:
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    return (k.reshape(b, se, kvh, hd).transpose(1, 2),
            v.reshape(b, se, kvh, hd).transpose(1, 2))


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
    H*(dn+dr)); the matrices stored in ``dtype`` (default ``cfg.dtype``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d, h, dt = cfg.d_model, cfg.n_heads, dtype or cfg.adtype
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
    h, dn, dr, dt = cfg.n_heads, cfg.qk_nope, cfg.qk_rope_dim, cfg.adtype
    if cfg.q_lora_rank:
        q = rmsnorm(x @ p.w_dq.to(dt), p.q_norm, cfg.norm_eps) @ p.w_uq.to(dt)
    else:
        q = x @ p.wq.to(dt)
    q = q.reshape(b, s, h, dn + dr)
    return q[..., :dn], q[..., dn:]     # nope (B,S,H,dn), rope (B,S,H,dr)


def v_pad_to(v: torch.Tensor, d: int) -> torch.Tensor:
    """Pad the value head dim with zeros to ``d`` (K's head dim), so one
    attention kernel takes K and V."""
    if v.shape[-1] == d:
        return v
    return torch.nn.functional.pad(v, (0, d - v.shape[-1]))


def mla_apply(cfg: ModelConfig, p: MLAttention, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              cache: Optional[Cache] = None,
              valid: Optional[torch.Tensor] = None,
              page_table: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """MLA attention (``causal`` applies without a cache).  cache =
    {"ckv": (B,Smax,r), "kr": (B,Smax,dr), "len": (B,)}, the
    compressed-latent cache, or the paged layout
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

    ckv = rmsnorm(x @ p.w_dkv.to(dt), p.kv_norm, cfg.norm_eps)  # (B,S,r)
    kr = rope((x @ p.w_kr.to(dt))[:, None], positions[:, None, :],
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
        ckv_p = _scatter_vec_pages(gather_pool(cfg, cache["ckvp"]), ckv,
                                   pos, valid, page_table)
        kr_p = _scatter_vec_pages(gather_pool(cfg, cache["krp"]), kr[:, 0],
                                  pos, valid, page_table)
        keep_shard(cfg, cache["ckvp"], ckv_p)
        keep_shard(cfg, cache["krp"], kr_p)
        lens = pos + valid.sum(-1).to(pos.dtype)
        ckv_full = _gather_vec_pages(ckv_p, page_table)          # (B,Slog,r)
        kr_full = _gather_vec_pages(kr_p, page_table)[:, None]
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
    k_nope = (ckv_full @ p.w_uk.to(dt)).reshape(b, s_kv, h, dn)
    k_nope = k_nope.transpose(1, 2)
    v = (ckv_full @ p.w_uv.to(dt)).reshape(b, s_kv, h, dv).transpose(1, 2)
    k = torch.cat([k_nope, kr_full.expand(b, h, s_kv, dr).to(dt)], -1)
    qk = torch.cat([q_nope, q_rope], -1)                        # (B,H,S,dn+dr)
    v = v_pad_to(v, k.shape[-1])

    if cache is None:
        out = _prefill_attention(cfg, qk, k, v, causal=causal,
                                 window=None)[..., :dv]
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
    return out @ p.wo.to(dt), cache


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
