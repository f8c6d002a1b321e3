"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) head_dim=64
d_ff=512 (per-expert), vocab=49155, MoE 40 experts top-8, tied
embeddings — the same configuration as
``repro.configs.granite_moe_3b_a800m``."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    moe_d_ff=512,
    n_experts=40,
    top_k=8,
    vocab=49_155,
    tie_embeddings=True,
)
