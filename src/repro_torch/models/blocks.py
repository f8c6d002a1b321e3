"""Per-layer blocks: the counterpart of ``repro.models.blocks`` for the
``attn`` kind (self-attention + MLP), the ``moe`` kind (self-attention +
mixture of experts), the self-attention GQA or MLA as ``cfg.attn_kind``
says; the Hymba hybrid's ``hymba`` (windowed attention and an SSM in
parallel, then MLP) and ``hymba_global`` (the same with full attention);
RWKV6's ``rwkv`` (time-mix + channel-mix); and the encoder-decoder's
``enc`` (bidirectional self-attention + MLP, no window) and ``xattn``
(causal self-attention with a cache, cross attention on the encoder's
K/V, then MLP).

A block with a cache updates it in place: attention writes its K/V
views, and the recurrent states are copied into theirs."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.attention import (GQAttention, MLAttention,
                                         cross_attn_apply, gqa_apply,
                                         mla_apply)
from repro_torch.models.common import ModelConfig, norm_param, stream_norm
from repro_torch.models.mlp import MLP, mlp_apply
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.rwkv import (RWKVChannelMix, RWKVTimeMix,
                                     rwkv_channel_apply, rwkv_state_init,
                                     rwkv_time_apply)
from repro_torch.models.ssm import SSM, ssm_apply, ssm_init_state

KINDS = ("attn", "moe", "hymba", "hymba_global", "rwkv", "enc", "xattn")
PAGED_KINDS = ("attn", "moe")      # recurrent state has no growing KV to page


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")


def _attn_apply(cfg: ModelConfig, p: nn.Module, x: torch.Tensor,
                positions: torch.Tensor, window: Optional[int], **kw):
    if cfg.attn_kind == "mla":
        return mla_apply(cfg, p, x, positions, **kw)
    return gqa_apply(cfg, p, x, positions, window=window, **kw)


def _store(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]
           ) -> None:
    """Copy new recurrent states into the layer's cache views."""
    for k, v in new.items():
        cache[k].copy_(v)


class Block(nn.Module):
    """One pre-norm decoder layer, its matrices stored in ``dtype``
    (default ``cfg.dtype``): ``ln1``, ``attn``, ``ln2`` and ``mlp`` (kind
    ``attn`` and ``enc``) or ``moe`` (kind ``moe``); ``ln1``, ``attn``,
    ``ssm``, ``ln2`` and ``mlp`` (``hymba``, ``hymba_global``); ``ln1``,
    ``time``, ``ln2`` and ``chan`` (``rwkv``); ``ln1``, ``attn``,
    ``lnx``, ``xattn`` (always GQA), ``ln2`` and ``mlp`` (``xattn``)."""

    def __init__(self, cfg: ModelConfig, kind: str, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        _check_kind(kind)
        self.ln1 = norm_param(cfg.d_model, device)
        if kind == "rwkv":
            self.time = RWKVTimeMix(cfg, device, generator, dtype)
        else:
            attn = MLAttention if cfg.attn_kind == "mla" else GQAttention
            self.attn = attn(cfg, device, generator, dtype)
        if kind == "xattn":
            self.lnx = norm_param(cfg.d_model, device)
            self.xattn = GQAttention(cfg, device, generator, dtype)
        if kind in ("hymba", "hymba_global"):
            self.ssm = SSM(cfg, device, generator, dtype)
        self.ln2 = norm_param(cfg.d_model, device)
        if kind == "moe":
            self.moe = MoE(cfg, device, generator, dtype)
        elif kind == "rwkv":
            self.chan = RWKVChannelMix(cfg, device, generator, dtype)
        else:
            self.mlp = MLP(cfg, device, generator, dtype=dtype)


def block_apply(cfg: ModelConfig, kind: str, p: Block, x: torch.Tensor,
                positions: torch.Tensor, *,
                cache: Optional[Dict[str, Any]] = None,
                enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                valid: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """``valid`` (B, S) marks which of the S tokens are real per row;
    ``None`` means all are.  A paged cache also needs ``page_table``.
    Without a cache this is the cache-free forward (``lm_apply``,
    ``encode``).  An ``xattn`` block takes the encoder's ``enc_kv`` and,
    given ``valid`` (serving's chunked fill), attends it one query at a
    time.  A cache is updated in place and returned.  Every kind runs in
    a sharded step too (``launch/steps.py``): each mixer cuts itself over
    ``model`` and adds its partial sums there; on a residual stream cut
    along its tokens (``act_sp``) ``x`` is this rank's tokens, each
    sublayer reads the norm of them gathered whole (:func:`stream_norm`)
    and hands back its output's rank's tokens (``tp_out``): the whole
    sequence still runs through every mixer, recurrence and router."""
    _check_kind(kind)
    eps = cfg.norm_eps
    if kind == "xattn":
        h, ac = _attn_apply(cfg, p.attn, stream_norm(x, p.ln1, eps), positions,
                            None,
                            cache=None if cache is None else cache["attn"],
                            valid=valid)
        x = x + h
        x = x + cross_attn_apply(cfg, p.xattn, stream_norm(x, p.lnx, eps),
                                 enc_kv, per_query=valid is not None)
        x = x + mlp_apply(cfg, p.mlp, stream_norm(x, p.ln2, eps))
        return x, (None if cache is None else {"attn": ac})
    if kind in ("hymba", "hymba_global"):
        window = None if kind == "hymba_global" else cfg.window
        xin = stream_norm(x, p.ln1, eps)
        h_attn, _ = _attn_apply(cfg, p.attn, xin, positions, window,
                                cache=None if cache is None
                                else cache["attn"], valid=valid)
        h_ssm, sc = ssm_apply(cfg, p.ssm, xin,
                              None if cache is None else cache["ssm"],
                              valid=valid)
        if cache is not None:
            _store(cache["ssm"], sc)
        x = x + 0.5 * (h_attn + h_ssm)     # parallel heads, mean-combined
        x = x + mlp_apply(cfg, p.mlp, stream_norm(x, p.ln2, eps))
        return x, cache
    if kind == "rwkv":
        st = None if cache is None else {"shift": cache["time_shift"],
                                         "wkv": cache["wkv"]}
        h, ts = rwkv_time_apply(cfg, p.time, stream_norm(x, p.ln1, eps), st,
                                valid=valid)
        if cache is not None:
            _store(cache, {"time_shift": ts["shift"], "wkv": ts["wkv"]})
        x = x + h
        h, cs = rwkv_channel_apply(cfg, p.chan, stream_norm(x, p.ln2, eps),
                                   None if cache is None
                                   else cache["chan_shift"], valid=valid)
        if cache is not None:
            _store(cache, {"chan_shift": cs})
        return x + h, cache
    enc = kind == "enc"               # bidirectional, no window
    h, ac = _attn_apply(cfg, p.attn, stream_norm(x, p.ln1, eps), positions,
                        None if enc else cfg.window, causal=not enc,
                        cache=None if cache is None else cache["attn"],
                        valid=valid, page_table=page_table)
    x = x + h
    if kind == "moe":
        # serving: dropless dispatch (capacity drops would make decode
        # diverge from prefill); the cache-free forward: capacity factor
        cf = float(cfg.n_experts) if cache is not None else 0.0
        x = x + moe_apply(cfg, p.moe, stream_norm(x, p.ln2, eps),
                          capacity_factor=cf)
    else:
        x = x + mlp_apply(cfg, p.mlp, stream_norm(x, p.ln2, eps))
    return x, (None if cache is None else {"attn": ac})


def block_cache_init(cfg: ModelConfig, kind: str, count: int, batch: int,
                     s_max: int, device: torch.device) -> Dict[str, Any]:
    """Decode cache of ``count`` stacked layers of ``kind``: leaves
    ``(count, ...)`` as the JAX package stacks them.  ``hymba`` layers
    hold attention K/V and the SSM's {conv, ssm}; ``rwkv`` layers the
    flat ``time_shift``, ``wkv`` and ``chan_shift`` states; the
    encoder-decoder's kinds the attention K/V alone."""
    _check_kind(kind)
    if kind == "rwkv":
        return rwkv_state_init(cfg, count, batch, device)
    if cfg.attn_kind == "mla":     # the compressed latent and rope key
        shapes = {"ckv": (count, batch, s_max, cfg.kv_lora_rank),
                  "kr": (count, batch, s_max, cfg.qk_rope_dim)}
    else:
        kv = (count, batch, cfg.n_kv_heads, s_max, cfg.hd)
        shapes = {"k": kv, "v": kv}
    out = {"attn": _zeros(cfg, shapes, count, batch, device)}
    if kind in ("hymba", "hymba_global"):
        out["ssm"] = ssm_init_state(cfg, count, batch, device)
    return out


def block_cache_init_paged(cfg: ModelConfig, kind: str, count: int,
                           batch: int, n_pages: int, page: int,
                           device: torch.device) -> Dict[str, Any]:
    """Paged decode cache of ``count`` stacked layers: each layer has its
    own pool of ``n_pages`` pages, addressed through one page table.
    Page 0 is the reserved trash page (see ``PageAllocator``).  Only the
    pure-attention kinds page."""
    if kind not in PAGED_KINDS:
        raise ValueError(f"block kind {kind!r} has no paged cache")
    if cfg.attn_kind == "mla":     # latent pages
        shapes = {"ckvp": (count, n_pages, page, cfg.kv_lora_rank),
                  "krp": (count, n_pages, page, cfg.qk_rope_dim)}
    else:
        kv = (count, n_pages, cfg.n_kv_heads, page, cfg.hd)
        shapes = {"kp": kv, "vp": kv}
    return {"attn": _zeros(cfg, shapes, count, batch, device)}


def _zeros(cfg: ModelConfig, shapes: Dict[str, Tuple[int, ...]], count: int,
           batch: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Zero cache leaves of ``shapes`` in ``cfg.dtype`` and the int32
    lengths ``(count, batch)``."""
    out = {k: torch.zeros(s, dtype=cfg.adtype, device=device)
           for k, s in shapes.items()}
    out["len"] = torch.zeros((count, batch), dtype=torch.int32, device=device)
    return out
