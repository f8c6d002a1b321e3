"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + Mamba heads;
sliding-window attention (1024) with 3 global-attention layers — the
same configuration as ``repro.configs.hymba_1_5b``."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32_001,
    ssm_state=16,
    ssm_expand=2,
    window=1024,
    global_attn_layers=(0, 15, 31),
)
