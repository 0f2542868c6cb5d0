"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400; MLA (kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
qk_nope/v head_dim=128); MoE 2 shared + 160 routed experts top-6.
[arXiv:2405.04434]

Deviation noted in DESIGN.md: the real model's first layer uses a dense FFN;
we use MoE in all 60 layers (uniform scan groups).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,                    # unused by MLA (latent cache instead)
    head_dim=128,                      # qk_nope head dim
    d_ff=1536,                         # per-expert width
    vocab_size=102400,
    rope_theta=10_000.0,
    layer_pattern=("mla",),
    n_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    source="arXiv:2405.04434 (DeepSeek-V2)",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="dsv2-smoke", n_layers=2, d_model=256, n_heads=8,
        head_dim=32, d_ff=128, vocab_size=512, n_experts=4, moe_top_k=2,
        n_shared_experts=1, kv_lora_rank=64, q_lora_rank=48, rope_head_dim=16,
        v_head_dim=32)
