"""Modality frontend stand-ins, as the reference's.

[vlm] and [audio] architectures specify the transformer backbone only:
the vision encoder and the audio codec are not implemented. The
``precomputed_*_embeddings`` draw stand-ins of the interface's shape from
a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import torch

# Output feature width of each stubbed frontend: InternViT-6B patch
# embeddings after the projector (vision), EnCodec 32kHz frame embeddings
# (audio, musicgen's conditioning stream).
_FRONTEND_DIM = {"vision": 1024, "audio": 128}

VLM_IMAGE_TOKENS = 256      # one 448x448 tile after pixel shuffle


def frontend_dim(kind: str) -> int:
    return _FRONTEND_DIM[kind]


def precomputed_vision_embeddings(generator: Optional[torch.Generator],
                                  batch: int,
                                  n_tokens: int = VLM_IMAGE_TOKENS,
                                  dtype=torch.bfloat16,
                                  device=None) -> torch.Tensor:
    """Stand-in for InternViT patch embeddings, (B, n_tokens, 1024)."""
    return torch.randn((batch, n_tokens, _FRONTEND_DIM["vision"]),
                       generator=generator, device=device).to(dtype)


def precomputed_audio_embeddings(generator: Optional[torch.Generator],
                                 batch: int, n_frames: int,
                                 dtype=torch.bfloat16,
                                 device=None) -> torch.Tensor:
    """Stand-in for EnCodec frame embeddings, (B, n_frames, 128)."""
    return torch.randn((batch, n_frames, _FRONTEND_DIM["audio"]),
                       generator=generator, device=device).to(dtype)
