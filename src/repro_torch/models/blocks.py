"""Per-layer blocks: the counterpart of ``repro.models.blocks`` for the
``attn`` kind (self-attention + MLP).  The MoE, hybrid, RWKV and
encoder-decoder kinds wait for later slices."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.attention import GQAttention, gqa_apply
from repro_torch.models.common import ModelConfig, norm_param, rmsnorm
from repro_torch.models.mlp import MLP, mlp_apply


class Block(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp``: one pre-norm decoder layer."""

    def __init__(self, cfg: ModelConfig, kind: str, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kind != "attn":
            raise NotImplementedError(f"block kind {kind!r} is not ported")
        self.ln1 = norm_param(cfg.d_model, device)
        self.attn = GQAttention(cfg, device, generator)
        self.ln2 = norm_param(cfg.d_model, device)
        self.mlp = MLP(cfg, device, generator)


def block_apply(cfg: ModelConfig, kind: str, p: Block, x: torch.Tensor,
                positions: torch.Tensor, *,
                cache: Optional[Dict[str, Any]] = None,
                valid: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """``valid`` (B, S) marks which of the S tokens are real per row;
    ``None`` means all are.  A paged cache also needs ``page_table``."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    eps = cfg.norm_eps
    h, ac = gqa_apply(cfg, p.attn, rmsnorm(x, p.ln1, eps), positions,
                      cache=None if cache is None else cache["attn"],
                      valid=valid, page_table=page_table)
    x = x + h
    x = x + mlp_apply(cfg, p.mlp, rmsnorm(x, p.ln2, eps))
    return x, (None if cache is None else {"attn": ac})


def block_cache_init(cfg: ModelConfig, kind: str, count: int, batch: int,
                     s_max: int, device: torch.device) -> Dict[str, Any]:
    """Decode cache of ``count`` stacked layers of ``kind``: leaves
    ``(count, ...)`` as the JAX package stacks them."""
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
    if kind != "attn":
        raise ValueError(f"block kind {kind!r} has no paged cache")
    hd, kvh = cfg.hd, cfg.n_kv_heads
    shape = (count, n_pages, kvh, page, hd)
    return {"attn": {
        "kp": torch.zeros(shape, dtype=cfg.adtype, device=device),
        "vp": torch.zeros(shape, dtype=cfg.adtype, device=device),
        "len": torch.zeros((count, batch), dtype=torch.int32, device=device)}}
