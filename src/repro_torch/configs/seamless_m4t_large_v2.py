"""seamless-m4t-large-v2 [audio]: the encoder-decoder backbone, 24
encoder + 24 decoder layers, d_model=1024 16H (kv=16) d_ff=8192 relu
vocab=256206 — the same configuration as
``repro.configs.seamless_m4t_large_v2``.  The audio frontend is a stub:
requests carry precomputed frame embeddings (S_enc, d_model)."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256_206,
    mlp_kind="relu",
    norm_eps=1e-5,
)
