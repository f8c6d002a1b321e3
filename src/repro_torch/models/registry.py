"""Model registry: the counterpart of ``repro.models.registry``
for the dense and MoE decoder families.

``build_model(cfg, device=None)`` returns a :class:`ModelBundle` whose
functions mirror JAX's, with the device fixed at build time (``cuda``
unless the caller passes ``"cpu"``; no card and no explicit CPU request
raises):

  init(generator, dtype=None) -> params        (an ``LM`` on the device;
                                                dtype=cfg.pdtype to train)
  loss(params, batch) -> scalar                (train objective)
  apply(params, tokens) -> logits              (cache-free forward)
  cache_init(batch, s_max), decode_step(params, cache, token, pos)
  prefill(params, cache, tokens, pos, n_valid) (chunked cache fill)
  cache_reset(cache, keep_mask)                (slot recycling)
  cache_init_paged(batch, n_pages, page)       (pooled KV pages)
  prefill_paged(params, cache, tok, pos, n_valid, page_table)
  copy_pages(cache, src, dst)                  (COW primitive)
  cache_reset_paged(cache, keep_mask, new_lens)

Caches are updated in place and returned, so the serve loop reads like
JAX's.  ``loss`` covers the dense, MoE, MLA and MLA + MoE families the
port has; the encoder-decoder's waits for that family.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models import transformer as _t
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    loss: Callable
    apply: Callable
    cache_init: Callable
    decode_step: Callable
    prefill: Callable
    cache_reset: Callable
    cache_init_paged: Callable
    prefill_paged: Callable
    copy_pages: Callable
    cache_reset_paged: Callable


def cache_reset(cache: Any, keep: torch.Tensor) -> Any:
    """Zero, in place, the decode-cache rows where ``keep`` (B,) is
    False.  Every leaf is stacked ``(layers, B, ...)``, so K/V rows and
    lengths of recycled slots all reset."""
    for seg in cache:
        for a in seg["attn"].values():
            m = keep.reshape((1, keep.shape[0]) + (1,) * (a.dim() - 2))
            a.masked_fill_(~m, 0)
    return cache


def build_model(cfg: ModelConfig,
                device: Union[None, str, torch.device] = None
                ) -> ModelBundle:
    dev = resolve_device(device)
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
        cache_init_paged=lambda b, n_pages, page:
            _t.lm_cache_init_paged(cfg, b, n_pages, page, dev),
        prefill_paged=lambda p, cache, tok, pos, n_valid, page_table:
            _t.lm_prefill(cfg, p, cache, tok, pos, n_valid,
                          page_table=page_table),
        copy_pages=_t.lm_copy_pages,
        cache_reset_paged=_t.lm_paged_reset,
    )
