"""rwkv6-1.6b [ssm] "Finch": 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536, data-dependent decay — the same configuration as
``repro.configs.rwkv6_1_6b``."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab=65_536,
    rwkv_head_dim=64,
)
