"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152; llama-arch code model [arXiv:2405.04324; hf] — the same
configuration as ``repro.configs.granite_34b``."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24_576,
    vocab=49_152,
    mlp_kind="gelu",
)
