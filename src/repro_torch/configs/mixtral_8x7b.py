"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (W=4096).
[arXiv:2401.04088]
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    layer_pattern=("local",),          # every layer is SWA in Mixtral
    sliding_window=4096,
    n_experts=8,
    moe_top_k=2,
    source="arXiv:2401.04088 (Mixtral of Experts)",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="mixtral-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512, n_experts=4,
        moe_top_k=2, sliding_window=64)
