"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536, qk-norm; early-fusion VQ image tokens arrive already fused
into the token ids (the frontend is a stub, as in the reference) — the
same configuration as ``repro.configs.chameleon_34b``."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab=65_536,
    qk_norm=True,
)
