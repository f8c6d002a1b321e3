"""Model registry: the counterpart of ``repro.models.registry`` for
every family: the decoders (dense, MoE, the early-fusion ``vlm``, and
the recurrent ``ssm`` (RWKV6) and ``hybrid`` (Hymba)) and the
encoder-decoder (``encdec``).

``build_model(cfg, device=None)`` returns a :class:`ModelBundle` whose
functions mirror JAX's, with the device fixed at build time (``cuda``
unless the caller passes ``"cpu"``; no card and no explicit CPU request
raises):

  init(generator, dtype=None) -> params        (an ``LM`` or ``EncDec``
                                                on the device;
                                                dtype=cfg.pdtype to train)
  loss(params, batch) -> scalar                (train objective)
  apply(params, tokens) -> logits              (decoders' cache-free
                                                forward; None for encdec)
  encode(params, frames) -> enc_out            (encdec only)
  cache_init(batch, s_max), decode_step(params, cache, token, pos)
  prefill(params, cache, tokens, pos, n_valid) (chunked cache fill)
  cache_reset(cache, keep_mask)                (slot recycling)
plus, for the pure-attention families (layer kinds in {attn, moe}):
  cache_init_paged(batch, n_pages, page)       (pooled KV pages)
  prefill_paged(params, cache, tok, pos, n_valid, page_table)
  copy_pages(cache, src, dst)                  (COW primitive)
  cache_reset_paged(cache, keep_mask, new_lens)
  gather_pages(cache, pages) -> blocks         (disaggregated serving's
  scatter_pages(cache, blocks, pages, slot,     page migration)
                new_len)

These six are ``None`` for the recurrent families and the
encoder-decoder: ``PagedServeLoop`` serves them on the contiguous path.
The encoder-decoder's ``decode_step`` and ``prefill`` take ``enc_out``
first, as JAX's do.  Caches are updated in place and returned, so the
serve loop reads like JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models import encdec as _encdec
from repro_torch.models import transformer as _t
from repro_torch.models.blocks import PAGED_KINDS
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    loss: Callable
    apply: Optional[Callable]
    cache_init: Callable
    decode_step: Callable
    prefill: Callable
    cache_reset: Callable
    encode: Optional[Callable] = None
    cache_init_paged: Optional[Callable] = None
    prefill_paged: Optional[Callable] = None
    copy_pages: Optional[Callable] = None
    cache_reset_paged: Optional[Callable] = None
    gather_pages: Optional[Callable] = None
    scatter_pages: Optional[Callable] = None


def cache_reset(cache: Any, keep: torch.Tensor) -> Any:
    """Zero, in place, the decode-cache rows where ``keep`` (B,) is
    False, in every leaf: of every segment (a decoder's list of them) or
    of the encoder-decoder's one dict.  Every leaf is stacked
    ``(layers, B, ...)``, so attention K/V and lengths, MLA latents, SSM
    conv/state windows and RWKV shift/WKV states all reset: attention
    masks stale K/V by length, but recurrent states carry over into the
    next request of a recycled slot unless they are zeroed."""
    def zero(tree):
        for a in (tree.values() if isinstance(tree, dict) else tree):
            if isinstance(a, (dict, list)):
                zero(a)
            else:
                m = keep.reshape((1, keep.shape[0]) + (1,) * (a.dim() - 2))
                a.masked_fill_(~m, 0)
    zero(cache)
    return cache


def build_model(cfg: ModelConfig,
                device: Union[None, str, torch.device] = None
                ) -> ModelBundle:
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return ModelBundle(
            cfg=cfg,
            device=dev,
            init=lambda generator, dtype=None:
                _encdec.encdec_init(cfg, generator, dev, dtype),
            loss=lambda p, batch: _encdec.encdec_loss(cfg, p, batch),
            apply=None,
            encode=lambda p, frames: _encdec.encode(cfg, p, frames),
            cache_init=lambda b, s:
                _encdec.encdec_cache_init(cfg, b, s, dev),
            decode_step=lambda p, enc_out, cache, tok, pos:
                _encdec.encdec_decode_step(cfg, p, enc_out, cache, tok, pos),
            prefill=lambda p, enc_out, cache, tok, pos, n_valid:
                _encdec.encdec_prefill(cfg, p, enc_out, cache, tok, pos,
                                       n_valid),
            cache_reset=cache_reset,
        )
    # the decoders (dense, moe, vlm, ssm, hybrid)
    paged = {spec.kind for spec in cfg.layer_specs()} <= set(PAGED_KINDS)
    return ModelBundle(
        cfg=cfg,
        device=dev,
        init=lambda generator, dtype=None:
            _t.lm_init(cfg, generator, dev, dtype),
        loss=lambda p, batch: _t.lm_loss(cfg, p, batch),
        apply=lambda p, tokens: _t.lm_apply(cfg, p, tokens),
        cache_init=lambda b, s: _t.lm_cache_init(cfg, b, s, dev),
        decode_step=lambda p, cache, tok, pos:
            _t.lm_decode_step(cfg, p, cache, tok, pos),
        prefill=lambda p, cache, tok, pos, n_valid:
            _t.lm_prefill(cfg, p, cache, tok, pos, n_valid),
        cache_reset=cache_reset,
        cache_init_paged=(
            (lambda b, n_pages, page:
             _t.lm_cache_init_paged(cfg, b, n_pages, page, dev))
            if paged else None),
        prefill_paged=(
            (lambda p, cache, tok, pos, n_valid, page_table:
             _t.lm_prefill(cfg, p, cache, tok, pos, n_valid,
                           page_table=page_table))
            if paged else None),
        copy_pages=_t.lm_copy_pages if paged else None,
        cache_reset_paged=_t.lm_paged_reset if paged else None,
        gather_pages=_t.lm_gather_pages if paged else None,
        scatter_pages=_t.lm_scatter_pages if paged else None,
    )
