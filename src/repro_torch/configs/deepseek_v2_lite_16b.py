"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H MLA (kv_lora=512, no
q_lora, rope 64, nope 128, v 128); 2 shared + 64 routed experts top-6,
d_ff=1408 per expert; the first layer a dense FFN (d_ff=10944);
vocab=102400 [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite] — the
same configuration as ``repro.configs.deepseek_v2_lite_16b``."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10_944,            # the single leading dense-FFN layer
    moe_d_ff=1_408,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    first_dense_layers=1,
    vocab=102_400,
    attn_kind="mla",
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
)
