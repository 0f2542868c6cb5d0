"""stablelm-3b [dense] — 32L d_model=2560 32H (MHA, kv=32) d_ff=6912
vocab=50304. [hf:stabilityai/stablelm-2-1_6b family]
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    rope_theta=10_000.0,
    layer_pattern=("global",),
    source="hf:stabilityai/stablelm-2-1_6b (StableLM 2 model card)",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="stablelm-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=8, head_dim=32, d_ff=512, vocab_size=512)
