"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064; QKV bias — the same configuration as
``repro.configs.qwen2_72b``."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29_568,
    vocab=152_064,
    qkv_bias=True,
    rope_theta=1e6,
)
