"""mamba2-780m [ssm] — 48L d_model=1536 attention-free, vocab=50280,
SSD (state-space duality), ssm_state=128, d_inner=2*d_model=3072,
48 heads x head_dim 64. [arXiv:2405.21060]

Pure mixer stack: d_ff=0 (Mamba-2 blocks have no separate FFN).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("ssd",),
    ssm_state=128,
    ssm_heads=48,                      # d_inner 3072 / head_dim 64
    ssm_expand=2,
    conv_width=4,
    ssm_chunk=256,
    source="arXiv:2405.21060 (Mamba-2 / Transformers are SSMs)",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", n_layers=2, d_model=128, vocab_size=512,
        ssm_state=16, ssm_heads=8, ssm_chunk=16)
