"""The GQA attention mixer, full-sequence path (train / prefill).

Shapes: x (B, S, D); q (B, S, H, hd); k/v (B, S, KV, hd); weights
``wq (D, H, hd)``, ``wk``/``wv (D, KV, hd)``, ``wo (H, hd, D)``, the
reference's layouts. Scores are divided by sqrt(hd), causally masked and
soft-maxed in fp32. Sequences up to ``DIRECT_ATTN_MAX_SEQ`` take the
masked-einsum path; the chunked online-softmax path for longer ones, MLA
and decode against a cache are not ported.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import (NEG_INF, Init, ModelConfig, Params,
                                       apply_rope, dense_init)

# Sequences at or below this use the plain masked-einsum path.
DIRECT_ATTN_MAX_SEQ = 4096


def init_attention(init: Init, cfg: ModelConfig) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.param_dtype
    p = {"wq": dense_init(init, (d, h, hd), dt),
         "wk": dense_init(init, (d, kv, hd), dt),
         "wv": dense_init(init, (d, kv, hd), dt),
         "wo": dense_init(init, (h, hd, d), dt, fan_in=h * hd)}
    if cfg.qkv_bias:
        p["bq"] = init.full((h, hd), 0.0, dt)
        p["bk"] = init.full((kv, hd), 0.0, dt)
        p["bv"] = init.full((kv, hd), 0.0, dt)
    return p


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Sq,H,hd), k (B,Sk,KV,hd) -> scores (B,KV,G,Sq,Sk), H = KV*G."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    return torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B,KV,G,Sq,Sk), v (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    b, kvh, g, sq, _ = probs.shape
    o = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return o.reshape(b, sq, kvh * g, v.shape[-1])


def direct_attention(q, k, v, q_pos, k_pos, window: int = 0
                     ) -> torch.Tensor:
    """Masked-einsum attention; fine up to a few thousand tokens."""
    hd = q.shape[-1]
    scores = _gqa_scores(q, k) / math.sqrt(hd)
    mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask = mask & (k_pos[None, :] > (q_pos[:, None] - window))
    scores = torch.where(mask[None, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v).to(q.dtype)


def attention_any(q, k, v, q_pos, k_pos, window: int = 0) -> torch.Tensor:
    if k.shape[1] <= DIRECT_ATTN_MAX_SEQ:
        return direct_attention(q, k, v, q_pos, k_pos, window)
    raise NotImplementedError(
        f"{k.shape[1]} keys: the chunked attention path for sequences "
        f"over {DIRECT_ATTN_MAX_SEQ} tokens is not ported")


def _qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Full-sequence causal attention. positions: (S,) int32."""
    q, k, v = _qkv(p, cfg, x, positions)
    o = attention_any(q, k, v, positions, positions, window)
    return torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])
