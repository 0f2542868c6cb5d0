"""internvl2-76b [vlm] — InternViT-6B + 76B language backbone (Llama-3-70B
derived), 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
[arXiv:2404.16821]

Backbone-only per the carve-out: the vision encoder is a stub; the config is
the language transformer that consumes precomputed patch embeddings.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    layer_pattern=("global",),
    frontend="vision",
    source="arXiv:2404.16821 (InternVL2); backbone per Llama-3-70B geometry",
)


def reduced() -> ModelConfig:
    """2-layer, d_model<=512 smoke variant of the same family."""
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="internvl2-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512)
