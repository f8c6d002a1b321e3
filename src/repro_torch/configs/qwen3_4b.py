"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) head_dim=128
d_ff=9728 vocab=151936; qk_norm — the same configuration as
``repro.configs.qwen3_4b``."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151_936,
    qk_norm=True,
    rope_theta=1e6,
)
