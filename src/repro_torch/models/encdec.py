"""Encoder-decoder assembly (the seamless-m4t backbone): the counterpart
of ``repro.models.encdec``.

The modality frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, D).  The encoder is a stack of
``enc`` blocks (bidirectional self-attention: the ``flash`` kernel with
``causal=False`` in ``kernel`` mode); the decoder a stack of ``xattn``
blocks whose cross attention reads K/V projected from the encoder output
by each layer at every step (``cross_kv``, recomputed as the reference
recomputes it).  The token embedding is ``transformer.embed_tokens``,
the ``dae_gather`` kernel.

Layers run as a Python loop over each stack's ``nn.ModuleList``; the
decode cache is one dict whose leaves stack the decoder's layers,
``{"attn": {"k", "v": (L, B, KVH, Smax, hd), "len": (L, B)}}`` as JAX's,
updated in place.  Under autograd with ``cfg.remat`` each layer is
recomputed in backward, as JAX's ``jax.checkpoint`` of the layer body.

In a sharded step the blocks cut themselves over ``model``, the cross
attention's K/V are the rank's KV heads, and the head is
``transformer.lm_logits``: where ``model`` divides the vocab the
embedding, the logits and the loss are vocab-parallel, else whole.  With
``act_sp`` the encoder's and the teacher-forced decoder's residual
streams are each cut along their own tokens where ``model`` divides
them; the encoder output is gathered whole, as the cross attention
reads it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.models.attention import cross_kv
from repro_torch.models.blocks import Block, block_apply, block_cache_init
from repro_torch.models.common import (ModelConfig, cross_entropy_loss,
                                       dense_param, norm_param, rmsnorm,
                                       stream_norm)
from repro_torch.models.transformer import (_layer_view, embed_tokens,
                                           lm_logits)
from repro_torch.parallel.sharding import (in_current_shards, model_cut,
                                           residual_stream, tp_out)

Cache = Dict[str, Any]


class EncDec(nn.Module):
    """``encdec_init``'s tree: ``embed`` (vocab, d_model) in
    ``cfg.param_dtype``, ``enc`` (``n_enc_layers`` ``enc`` blocks),
    ``enc_norm``, ``dec`` (``n_layers`` ``xattn`` blocks),
    ``final_norm`` and ``unembed`` (d_model, vocab); the matrices other
    than ``embed`` stored in ``dtype`` (default ``cfg.dtype``; see
    ``transformer.LM``).  Without a generator the weights are left
    uninitialised for ``convert.params_from_numpy`` to fill."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dtype = dtype or cfg.adtype
        self.embed = dense_param((cfg.vocab, cfg.d_model), cfg.pdtype, device,
                                 generator)
        self.enc = nn.ModuleList([Block(cfg, "enc", device, generator, dtype)
                                  for _ in range(cfg.n_enc_layers)])
        self.enc_norm = norm_param(cfg.d_model, device)
        self.dec = nn.ModuleList([Block(cfg, "xattn", device, generator,
                                        dtype)
                                  for _ in range(cfg.n_layers)])
        self.final_norm = norm_param(cfg.d_model, device)
        self.unembed = dense_param((cfg.d_model, cfg.vocab), dtype, device,
                                   generator)


def encdec_init(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device, dtype: Optional[torch.dtype] = None
                ) -> EncDec:
    """Random weights drawn from ``generator`` (on ``device``)."""
    return EncDec(cfg, device, generator, dtype)


def _run(cfg: ModelConfig, fn, *args) -> torch.Tensor:
    """``fn(*args)``, recomputed in backward under autograd with
    ``cfg.remat`` (in a sharded step, in the step's shards)."""
    if cfg.remat and torch.is_grad_enabled():
        return _ckpt.checkpoint(in_current_shards(fn), *args,
                                use_reentrant=False)
    return fn(*args)


def _positions(b: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encode(cfg: ModelConfig, params: EncDec, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames (B, S_enc, D), the frontend's embeddings -> the encoder
    output (B, S_enc, D) in ``cfg.dtype``."""
    b, se, _ = frames.shape
    positions = _positions(b, se, frames.device)

    def layer(blk, h):
        return block_apply(cfg, "enc", blk, h, positions)[0]
    with residual_stream(se):
        x = tp_out(frames.to(cfg.adtype), False)   # the rank's tokens
        for blk in params.enc:
            x = _run(cfg, layer, blk, x)
        return stream_norm(x, params.enc_norm, cfg.norm_eps)


def decode_train(cfg: ModelConfig, params: EncDec, enc_out: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The teacher-forced decoder: tokens (B, S) attending ``enc_out`` ->
    logits (B, S, V) in ``cfg.dtype`` (a sharded step's vocab slice where
    ``model`` cuts the vocab)."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)

    def layer(blk, h):
        return block_apply(cfg, "xattn", blk, h, positions,
                           enc_kv=cross_kv(cfg, blk.xattn, enc_out))[0]
    with residual_stream(s):
        x = embed_tokens(cfg, params, tokens)
        for blk in params.dec:
            x = _run(cfg, layer, blk, x)
        x = stream_norm(x, params.final_norm, cfg.norm_eps)
    return lm_logits(cfg, params, x)


def encdec_loss(cfg: ModelConfig, params: EncDec,
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The mean cross-entropy of the decoder's logits of
    ``batch["tokens"]`` against ``batch["labels"]`` (-1 ignored), the
    encoder reading ``batch["frames"]``."""
    enc_out = encode(cfg, params, batch["frames"])
    logits = decode_train(cfg, params, enc_out, batch["tokens"])
    cut = model_cut(params.unembed)
    return cross_entropy_loss(logits, batch["labels"],
                              vocab_slot=-1 if cut is None else cut[2])


# -- decode (serving) ---------------------------------------------------------


def encdec_cache_init(cfg: ModelConfig, batch: int, s_max: int,
                      device: torch.device) -> Cache:
    """The decoder's self-attention cache, every leaf ``(n_layers, ...)``."""
    return block_cache_init(cfg, "xattn", cfg.n_layers, batch, s_max, device)


def _decoder(cfg: ModelConfig, params: EncDec, enc_out: torch.Tensor,
             caches: Cache, x: torch.Tensor, positions: torch.Tensor,
             valid: Optional[torch.Tensor]) -> torch.Tensor:
    for i, blk in enumerate(params.dec):
        x, _ = block_apply(cfg, "xattn", blk, x, positions,
                           cache=_layer_view(caches, i),
                           enc_kv=cross_kv(cfg, blk.xattn, enc_out),
                           valid=valid)
    return rmsnorm(x, params.final_norm, cfg.norm_eps)


def encdec_decode_step(cfg: ModelConfig, params: EncDec,
                       enc_out: torch.Tensor, caches: Cache,
                       token: torch.Tensor, pos: torch.Tensor
                       ) -> Tuple[torch.Tensor, Cache]:
    """One decode step: token (B,), pos (B,) -> (logits (B, V) float32,
    caches updated in place)."""
    x = embed_tokens(cfg, params, token[:, None])
    x = _decoder(cfg, params, enc_out, caches, x, pos[:, None], None)
    return lm_logits(cfg, params, x[:, 0]).float(), caches


def encdec_prefill(cfg: ModelConfig, params: EncDec, enc_out: torch.Tensor,
                   caches: Cache, tokens: torch.Tensor, pos: torch.Tensor,
                   n_valid: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """Chunked, batched decoder cache fill (see ``transformer.lm_prefill``):
    tokens (B, C), pos (B,), n_valid (B,) -> (logits (B, V) float32 at
    each row's last valid token, caches updated in place).  The cross
    attention runs one query at a time (``per_query``)."""
    b, c = tokens.shape
    steps = torch.arange(c, dtype=pos.dtype, device=pos.device)
    positions = pos[:, None] + steps[None, :]
    valid = steps[None, :] < n_valid[:, None]
    x = embed_tokens(cfg, params, tokens)
    x = _decoder(cfg, params, enc_out, caches, x, positions, valid)
    last = torch.clamp(n_valid - 1, 0, c - 1).long()
    xl = x[torch.arange(b, device=x.device), last]             # (B, D)
    return lm_logits(cfg, params, xl).float(), caches
