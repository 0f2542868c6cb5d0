"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936; QKV bias, tied embeddings. [arXiv:2407.10671]
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=True,
    layer_pattern=("global",),
    source="arXiv:2407.10671 (Qwen2 Technical Report)",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="qwen2-smoke", n_layers=2, d_model=224, n_heads=14,
        n_kv_heads=2, head_dim=16, d_ff=448, vocab_size=512)
