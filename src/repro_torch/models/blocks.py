"""Per-layer blocks: the counterpart of ``repro.models.blocks`` for the
``attn`` kind (self-attention + MLP) and the ``moe`` kind
(self-attention + mixture of experts).  The hybrid, RWKV and
encoder-decoder kinds wait for later slices."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.attention import GQAttention, gqa_apply
from repro_torch.models.common import ModelConfig, norm_param, rmsnorm
from repro_torch.models.mlp import MLP, mlp_apply
from repro_torch.models.moe import MoE, moe_apply

KINDS = ("attn", "moe")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")


class Block(nn.Module):
    """``ln1``, ``attn``, ``ln2`` and ``mlp`` (kind ``attn``) or ``moe``
    (kind ``moe``): one pre-norm decoder layer."""

    def __init__(self, cfg: ModelConfig, kind: str, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_kind(kind)
        self.ln1 = norm_param(cfg.d_model, device)
        self.attn = GQAttention(cfg, device, generator)
        self.ln2 = norm_param(cfg.d_model, device)
        if kind == "moe":
            self.moe = MoE(cfg, device, generator)
        else:
            self.mlp = MLP(cfg, device, generator)


def block_apply(cfg: ModelConfig, kind: str, p: Block, x: torch.Tensor,
                positions: torch.Tensor, *,
                cache: Optional[Dict[str, Any]] = None,
                valid: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """``valid`` (B, S) marks which of the S tokens are real per row;
    ``None`` means all are.  A paged cache also needs ``page_table``.
    Without a cache this is the cache-free forward (``lm_apply``)."""
    _check_kind(kind)
    eps = cfg.norm_eps
    h, ac = gqa_apply(cfg, p.attn, rmsnorm(x, p.ln1, eps), positions,
                      window=cfg.window,
                      cache=None if cache is None else cache["attn"],
                      valid=valid, page_table=page_table)
    x = x + h
    if kind == "moe":
        # serving: dropless dispatch (capacity drops would make decode
        # diverge from prefill); the cache-free forward: capacity factor
        cf = float(cfg.n_experts) if cache is not None else 0.0
        x = x + moe_apply(cfg, p.moe, rmsnorm(x, p.ln2, eps),
                          capacity_factor=cf)
    else:
        x = x + mlp_apply(cfg, p.mlp, rmsnorm(x, p.ln2, eps))
    return x, (None if cache is None else {"attn": ac})


def block_cache_init(cfg: ModelConfig, kind: str, count: int, batch: int,
                     s_max: int, device: torch.device) -> Dict[str, Any]:
    """Decode cache of ``count`` stacked layers of ``kind``: leaves
    ``(count, ...)`` as the JAX package stacks them."""
    _check_kind(kind)
    hd, kvh = cfg.hd, cfg.n_kv_heads
    shape = (count, batch, kvh, s_max, hd)
    return {"attn": {
        "k": torch.zeros(shape, dtype=cfg.adtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.adtype, device=device),
        "len": torch.zeros((count, batch), dtype=torch.int32, device=device)}}


def block_cache_init_paged(cfg: ModelConfig, kind: str, count: int,
                           batch: int, n_pages: int, page: int,
                           device: torch.device) -> Dict[str, Any]:
    """Paged decode cache of ``count`` stacked layers: each layer has its
    own pool of ``n_pages`` pages, addressed through one page table.
    Page 0 is the reserved trash page (see ``PageAllocator``)."""
    if kind not in KINDS:
        raise ValueError(f"block kind {kind!r} has no paged cache")
    hd, kvh = cfg.hd, cfg.n_kv_heads
    shape = (count, n_pages, kvh, page, hd)
    return {"attn": {
        "kp": torch.zeros(shape, dtype=cfg.adtype, device=device),
        "vp": torch.zeros(shape, dtype=cfg.adtype, device=device),
        "len": torch.zeros((count, batch), dtype=torch.int32, device=device)}}
