"""Config helpers: the smoke-config reduction of ``repro.configs.base``."""

from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests: small widths, two
    layers (plus any leading dense ones; two encoder layers), few
    experts, small MLA ranks, head dims and SSM state, tiny vocab,
    float32."""
    kw = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 1,
        d_ff=128,
        vocab=512,
        head_dim=16 if cfg.head_dim else 0,
        dtype="float32",
    )
    if cfg.n_kv_heads == 1:
        kw["n_kv_heads"] = 1
    if cfg.family == "moe":
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2), moe_d_ff=64,
                  n_layers=2 + cfg.first_dense_layers,
                  first_dense_layers=cfg.first_dense_layers,
                  capacity_factor=8.0)  # dropless at smoke scale
    if cfg.attn_kind == "mla":
        kw.update(kv_lora_rank=32, q_lora_rank=min(cfg.q_lora_rank, 32),
                  qk_rope_dim=16, qk_nope_dim=16, v_head_dim=16)
    if cfg.family == "hybrid":
        kw.update(global_attn_layers=(0,), window=32, ssm_state=8,
                  ssm_expand=2)
    if cfg.family == "ssm":
        kw.update(rwkv_head_dim=16, d_ff=128)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2)
    if cfg.window:
        kw.setdefault("window", 32)
    return dataclasses.replace(cfg, **kw)
