"""The serving step functions: prefill_step and serve_step.

Functions of (params, inputs) with the config closed over, as the
reference's. Its ``make_train_step`` waits for the LM training slice.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import decode_step, prefill


def make_prefill_step(cfg: ModelConfig, moe_path: str = "gshard",
                      cache_seq: int = 0):
    """(params, inputs) -> (last-token logits, primed cache)."""

    def prefill_step(params, batch):
        logits, cache = prefill(params, cfg, tokens=batch.get("tokens"),
                                embeds=batch.get("embeds"),
                                cache_seq=cache_seq, moe_path=moe_path)
        return logits[:, -1:, :], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, token (B,1), cache) -> (logits (B,1,V), cache): ONE new
    token against the cache, which is updated in place."""

    def serve_step(params, token, cache):
        return decode_step(params, cfg, token, cache)

    return serve_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocabulary; ties go to the first maximum, as
    ``jnp.argmax``'s."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
