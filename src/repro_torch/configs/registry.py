"""Architecture registry, the four assigned input shapes and
``input_specs()``.

``input_specs(cfg, shape)`` returns every model input of that (arch,
shape) as a tensor on the ``meta`` device: the shapes and dtypes, with no
storage. ``concrete_inputs`` fills the same specs with draws from a
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional

import torch

from repro_torch import Device, resolve_device
from repro_torch.models.cache import init_cache
from repro_torch.models.common import ModelConfig
from repro_torch.models.frontends import VLM_IMAGE_TOKENS, frontend_dim

AUDIO_COND_FRAMES = 64   # musicgen conditioning prefix length

_MODULES = {
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
}

ARCH_IDS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# archs whose live decode state is sub-quadratic in S
LONG_CONTEXT_OK = frozenset(
    {"mamba2-780m", "recurrentgemma-9b", "gemma3-1b", "mixtral-8x7b"})


def get_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).reduced()


def supports_shape(cfg: ModelConfig, shape: InputShape) -> bool:
    if shape.name == "long_500k":
        return cfg.name in LONG_CONTEXT_OK
    return True


def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    if supports_shape(cfg, shape):
        return None
    return ("pure full-attention decoder: 500k decode requires sub-quadratic "
            "live state (DESIGN.md long_500k skip matrix)")


def _frontend_prefix(cfg: ModelConfig) -> int:
    if cfg.frontend == "vision":
        return VLM_IMAGE_TOKENS
    if cfg.frontend == "audio":
        return AUDIO_COND_FRAMES
    return 0


def input_specs(cfg: ModelConfig, shape: InputShape,
                batch_override: Optional[int] = None) -> Dict[str, Any]:
    """``meta`` tensors of every input for (arch, shape). Keys match the
    step functions:

      train  -> {tokens, labels[, embeds]}
      prefill-> {tokens[, embeds]}
      decode -> {token, cache}
    """
    return _inputs(cfg, shape, batch_override, torch.device("meta"), None)


def concrete_inputs(generator: Optional[torch.Generator], cfg: ModelConfig,
                    shape: InputShape, batch_override: Optional[int] = None,
                    device: Device = None) -> Dict[str, Any]:
    """Small concrete inputs matching ``input_specs`` (for smoke tests):
    tokens uniform below the vocabulary, embeds standard normal, a decode
    cache empty; on ``device`` (None: the card, raising without one)."""
    return _inputs(cfg, shape, batch_override, resolve_device(device),
                   generator)


def _inputs(cfg, shape, batch_override, dev, generator) -> Dict[str, Any]:
    b = batch_override or shape.global_batch
    s = shape.seq_len
    if shape.kind == "decode":
        return {"token": _tokens(cfg, (b, 1), dev, generator),
                "cache": init_cache(cfg, b, s, device=dev)}
    prefix = min(_frontend_prefix(cfg), s // 2)   # clamp for smoke shapes
    text = s - prefix
    out = {"tokens": _tokens(cfg, (b, text), dev, generator)}
    if prefix:
        out["embeds"] = torch.randn(
            (b, prefix, frontend_dim(cfg.frontend)), generator=generator,
            device=dev).to(cfg.param_dtype)
    if shape.kind == "train":
        out["labels"] = _tokens(cfg, (b, text), dev, generator)
    return out


def _tokens(cfg, size, dev, generator) -> torch.Tensor:
    return torch.randint(0, cfg.vocab_size, size, generator=generator,
                         dtype=torch.int32, device=dev)
