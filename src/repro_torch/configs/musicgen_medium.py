"""musicgen-medium [audio] — 48L d_model=1536 24H (MHA, kv=24) d_ff=6144
vocab=2048; decoder-only transformer over EnCodec audio tokens.
[arXiv:2306.05284]

Backbone-only carve-out: the EnCodec conv codec and T5 text conditioner are
stubs; training/prefill consume a short precomputed conditioning-frame prefix
(audio frontend stub) followed by the EnCodec token stream. The 4-codebook
delay pattern is collapsed to a single stream (noted in DESIGN.md).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    rope_theta=10_000.0,
    layer_pattern=("global",),
    frontend="audio",
    source="arXiv:2306.05284 (MusicGen / Simple and Controllable Music Generation)",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="musicgen-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=8, head_dim=32, d_ff=512, vocab_size=512)
