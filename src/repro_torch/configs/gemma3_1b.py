"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1, head_dim=256)
d_ff=6912 vocab=262144; 5:1 local(512-window):global attention, 32k/128k
context, tied embeddings. [hf:google/gemma-3-1b-pt]
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,                                  # 4x(5 local + 1 global) + 2
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    rope_theta=1_000_000.0,                       # global layers' base
    layer_pattern=("local",) * 5 + ("global",),
    sliding_window=512,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt (Gemma 3 model card)",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="gemma3-smoke", n_layers=8, d_model=128, n_heads=4,
        n_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512, sliding_window=16)
