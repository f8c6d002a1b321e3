"""Decoder-only LM assembly: the counterpart of
``repro.models.transformer``'s embedding (the ``dae_gather`` hook), the
cache-free forward ``lm_apply``, LM head, the training loss ``lm_loss``,
decode step, chunked prefill and paged-cache helpers.

The port runs eagerly: a segment's layers are a Python loop over its
``nn.ModuleList``, each layer reading and updating its slice of the
segment's stacked cache tensors in place.  Under autograd each layer of
the forward is rematerialised as ``cfg.remat`` and ``cfg.remat_policy``
say: ``"full"`` recomputes the whole layer in backward, ``"dots"`` keeps
the outputs of its plain matrix products (JAX's
``dots_with_no_batch_dims_saveable``: ``aten.mm``; the batched products
of attention and the experts are recomputed).

In a sharded step (``parallel/sharding.py::step_shards``) the vocab is
cut over ``model`` where it divides: the embedding gathers each token
from the rank that holds its row (the others add zeros) and the LM head
gives this rank's vocab slice, which ``cross_entropy_loss`` reduces
over ``model``.  With ``act_sp`` the cache-free forward holds its
residual stream as the rank's tokens from the embedding to the final
norm, which is gathered whole before the head; the decode steps and the
chunked prefill keep it whole, as JAX's do.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.kernels.dae_gather.ops import dae_gather
from repro_torch.models.blocks import (Block, block_apply, block_cache_init,
                                       block_cache_init_paged)
from repro_torch.models.common import (ModelConfig, cross_entropy_loss,
                                       dense_param, norm_param, rmsnorm,
                                       stream_norm)
from repro_torch.parallel.sharding import (in_current_shards, model_cut,
                                           residual_stream, tp_enter,
                                           tp_out, use)

Caches = List[Dict[str, Any]]
_PAGE_KEYS = ("kp", "vp", "ckvp", "krp")


class LM(nn.Module):
    """``embed`` (vocab, d_model) in ``cfg.param_dtype``, one
    ``nn.ModuleList`` of :class:`Block` per layer segment,
    ``final_norm`` and, unless ``cfg.tie_embeddings``, ``unembed``
    (d_model, vocab).  The matrices other than ``embed`` are stored in
    ``dtype``: serving's default ``cfg.dtype``, or ``cfg.param_dtype``
    (JAX's float32 masters, which training needs: an AdamW step of
    lr 3e-4 is below bfloat16's resolution).  Every use casts them to
    ``cfg.dtype``, a no-op on serving's storage.  Without a generator the
    weights are left uninitialised for ``convert.params_from_numpy`` to
    fill."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dtype = dtype or cfg.adtype
        self.embed = dense_param((cfg.vocab, cfg.d_model), cfg.pdtype, device,
                                 generator)
        self.segments = nn.ModuleList([
            nn.ModuleList([Block(cfg, spec.kind, device, generator, dtype)
                           for _ in range(spec.count)])
            for spec in cfg.layer_specs()])
        self.final_norm = norm_param(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.unembed = dense_param((cfg.d_model, cfg.vocab), dtype,
                                       device, generator)


def lm_init(cfg: ModelConfig, generator: torch.Generator,
            device: torch.device, dtype: Optional[torch.dtype] = None) -> LM:
    """Random weights drawn from ``generator`` (which must live on
    ``device``), the matrices stored in ``dtype`` (see :class:`LM`)."""
    return LM(cfg, device, generator, dtype)


def embed_tokens(cfg: ModelConfig, params: LM, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """Vocab-table gather — the framework's dae_gather hook.  On a vocab
    cut over ``model`` each rank gathers its rows (other tokens' ids
    clamped to row 0 and their rows zeroed) and the ranks' rows are
    summed: one nonzero term a token, so the sum is exact.  On a
    residual stream cut along its tokens (``act_sp``) the rows come back
    as this rank's tokens (the sum reduce-scattered)."""
    b, s = tokens.shape
    table = use(params.embed)
    cut = model_cut(params.embed)
    ids = tokens.reshape(-1)
    if cut is not None:
        ids = ids - cut[2] * table.shape[0]
        mine = (ids >= 0) & (ids < table.shape[0])
        ids = torch.where(mine, ids, 0)
    if cfg.kernel_mode == "kernel":
        rows = dae_gather(table, ids.to(torch.int32))
    else:
        rows = table[ids.long()]
    if cut is not None:
        rows = torch.where(mine[:, None], rows, 0.0)
    return tp_out(rows.reshape(b, s, cfg.d_model),
                  cut is not None).to(cfg.adtype)


def lm_logits(cfg: ModelConfig, params: LM, x: torch.Tensor
              ) -> torch.Tensor:
    """The LM head: ``x @ unembed``, or ``x @ embed.T`` cast to
    ``cfg.dtype`` when the embeddings are tied; on a vocab cut over
    ``model``, this rank's slice of the logits."""
    w = params.embed if cfg.tie_embeddings else params.unembed
    if model_cut(w) is not None:      # f: x enters this rank's vocab
        x = tp_enter(x)
    w = use(w)
    return x @ (w.T if cfg.tie_embeddings else w).to(cfg.adtype)


def _layer(cfg: ModelConfig, kind: str, layer, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    return block_apply(cfg, kind, layer, x, positions)[0]


def _dots_policy():
    return _ckpt.create_selective_checkpoint_contexts(
        [torch.ops.aten.mm.default])


def lm_apply(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
             positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The cache-free forward: tokens (B, S) -> logits (B, S, V) in
    ``cfg.dtype``, through the ``flash`` kernel in ``kernel`` mode.
    With gradients on and ``cfg.remat``, each layer is checkpointed (in
    a sharded step with ``act_sp``, on the rank's tokens of the
    stream)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    kw = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = _dots_policy
    with residual_stream(s):
        x = embed_tokens(cfg, params, tokens)
        layer_fn = in_current_shards(_layer)
        for spec, layers in zip(cfg.layer_specs(), params.segments):
            for layer in layers:
                if remat:
                    x = _ckpt.checkpoint(layer_fn, cfg, spec.kind, layer, x,
                                         positions, **kw)
                else:
                    x = _layer(cfg, spec.kind, layer, x, positions)
        x = stream_norm(x, params.final_norm, cfg.norm_eps)
    logits = lm_logits(cfg, params, x)
    if cfg.logit_soft_cap:
        logits = cfg.logit_soft_cap * torch.tanh(logits / cfg.logit_soft_cap)
    return logits


def lm_loss(cfg: ModelConfig, params: LM, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """The training objective: the mean cross-entropy of the logits of
    ``batch["tokens"]`` (B, S) against ``batch["labels"]`` (B, S), -1
    ignored."""
    logits = lm_apply(cfg, params, batch["tokens"])
    cut = model_cut(params.embed if cfg.tie_embeddings else params.unembed)
    return cross_entropy_loss(logits, batch["labels"],
                              vocab_slot=-1 if cut is None else cut[2])


def _layer_view(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Row ``i`` of every leaf of a segment's stacked cache (views, so
    writes land in the stack), nested as the cache is."""
    return {k: _layer_view(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layers(cfg: ModelConfig, params: LM, caches: Caches):
    """(kind, layer, per-layer cache view) for every layer in order."""
    for spec, layers, cache in zip(cfg.layer_specs(), params.segments,
                                   caches):
        for i, layer in enumerate(layers):
            yield spec.kind, layer, _layer_view(cache, i)


def lm_cache_init(cfg: ModelConfig, batch: int, s_max: int,
                  device: torch.device) -> Caches:
    return [block_cache_init(cfg, spec.kind, spec.count, batch, s_max, device)
            for spec in cfg.layer_specs()]


def lm_cache_init_paged(cfg: ModelConfig, batch: int, n_pages: int,
                        page: int, device: torch.device) -> Caches:
    """Paged decode caches: KV pages are pooled across all ``batch``
    slots; each layer of a segment gets its own pool (leaf shape
    ``(count, n_pages, ...)``) addressed by one shared page table."""
    return [block_cache_init_paged(cfg, spec.kind, spec.count, batch,
                                   n_pages, page, device)
            for spec in cfg.layer_specs()]


def lm_copy_pages(caches: Caches, src: int, dst: int) -> Caches:
    """Copy physical page ``src`` into page ``dst`` in every layer, in
    place — the allocator's copy-on-write primitive.  Copies every page
    pool a layer's cache holds (GQA's K/V pages, MLA's latent pages)."""
    for cache in caches:
        for key in _PAGE_KEYS:
            if key in cache["attn"]:
                a = cache["attn"][key]
                a[:, dst] = a[:, src]
    return caches


def lm_gather_pages(caches: Caches, pages: torch.Tensor
                    ) -> List[Dict[str, torch.Tensor]]:
    """Pull physical pages ``pages`` (n,) out of every layer's pool:
    leaf (count, NP, ...) -> block (count, n, ...).  One half of the
    disaggregated prefill->decode migration: the blocks keep the pool
    layout, so :func:`lm_scatter_pages` on another pool is a pure
    placement move."""
    return [{key: cache["attn"][key].index_select(1, pages)
             for key in _PAGE_KEYS if key in cache["attn"]}
            for cache in caches]


def lm_scatter_pages(caches: Caches, blocks: List[Dict[str, torch.Tensor]],
                     pages: torch.Tensor, slot: int, new_len: int
                     ) -> Caches:
    """Write migrated ``blocks`` (from :func:`lm_gather_pages`, on this
    pool's device) into physical pages ``pages`` of every layer's pool
    and set slot ``slot``'s logical length to ``new_len``, in place."""
    for cache, blk in zip(caches, blocks):
        attn = cache["attn"]
        for key in _PAGE_KEYS:
            if key in attn:
                attn[key].index_copy_(1, pages, blk[key].to(attn[key].dtype))
        attn["len"][:, slot] = new_len
    return caches


def lm_paged_reset(caches: Caches, keep: torch.Tensor,
                   new_lens: torch.Tensor) -> Caches:
    """Set the logical length of every slot where ``keep`` is False to
    ``new_lens`` (e.g. a reused prefix length), in place.  Page contents
    are untouched: positions < len are always freshly written by prefill
    and positions >= len are masked out of attention."""
    for cache in caches:
        ln = cache["attn"]["len"]
        ln.copy_(torch.where(keep[None, :], ln,
                             new_lens[None, :].to(ln.dtype)))
    return caches


def lm_decode_step(cfg: ModelConfig, params: LM, caches: Caches,
                   token: torch.Tensor, pos: torch.Tensor
                   ) -> Tuple[torch.Tensor, Caches]:
    """One decode step on a contiguous cache: token (B,), pos (B,) ->
    (logits (B, V) float32, caches updated in place)."""
    positions = pos[:, None]
    x = embed_tokens(cfg, params, token[:, None])
    for kind, layer, cache in _layers(cfg, params, caches):
        x, _ = block_apply(cfg, kind, layer, x, positions, cache=cache)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return lm_logits(cfg, params, x[:, 0]).float(), caches


def lm_prefill(cfg: ModelConfig, params: LM, caches: Caches,
               tokens: torch.Tensor, pos: torch.Tensor,
               n_valid: torch.Tensor,
               page_table: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Caches]:
    """Chunked, batched, teacher-forced cache fill — the serving Access
    engine's step (paper §3: the decoupled access stream).

    tokens (B, C) int32 — the next C prompt tokens per slot; pos (B,) —
    each slot's current position (== its cache length); n_valid (B,) —
    how many of the C tokens are real per slot (0 leaves that slot's
    cache and length untouched).  Returns (logits (B, V) float32 at each
    slot's LAST VALID token, caches updated in place).  A C=1 call with
    n_valid in {0, 1} is a masked decode step — the Execute engine's.
    """
    b, c = tokens.shape
    steps = torch.arange(c, dtype=pos.dtype, device=pos.device)
    positions = pos[:, None] + steps[None, :]
    valid = steps[None, :] < n_valid[:, None]
    x = embed_tokens(cfg, params, tokens)
    for kind, layer, cache in _layers(cfg, params, caches):
        x, _ = block_apply(cfg, kind, layer, x, positions, cache=cache,
                           valid=valid, page_table=page_table)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    last = torch.clamp(n_valid - 1, 0, c - 1).long()
    xl = x[torch.arange(b, device=x.device), last]             # (B, D)
    return lm_logits(cfg, params, xl).float(), caches
