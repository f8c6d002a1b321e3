"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448; MLA
(kv_lora=256, q_lora=768, rope 32, nope 64, v 64) [hf:openbmb/MiniCPM3-4B]
— the same configuration as ``repro.configs.minicpm3_4b``."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73_448,
    attn_kind="mla",
    kv_lora_rank=256,
    q_lora_rank=768,
    qk_rope_dim=32,
    qk_nope_dim=64,
    v_head_dim=64,
)
