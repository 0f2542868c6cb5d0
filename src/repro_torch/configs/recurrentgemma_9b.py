"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000; RG-LRU recurrent blocks + local attention in a 2:1 pattern
(rec, rec, local-attn), window 2048, lru_width=4096. [arXiv:2402.19427]

38 layers = 12 x (rec, rec, attn) + 2 remainder rec layers (two-scan stack).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    rope_theta=10_000.0,
    layer_pattern=("rec", "rec", "local"),
    sliding_window=2048,
    lru_width=4096,
    conv_width=4,
    tie_embeddings=True,
    source="arXiv:2402.19427 (Griffin / RecurrentGemma-9B model card)",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="rgemma-smoke", n_layers=5, d_model=128, n_heads=4,
        n_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512, lru_width=128,
        sliding_window=16)
