"""The attention mixers, GQA and DeepSeek-V2's MLA: full sequence (train
/ prefill) and one-token decode against a cache.

Shapes: x (B, S, D); q (B, S, H, hd); k/v (B, S, KV, hd); weights
``wq (D, H, hd)``, ``wk``/``wv (D, KV, hd)``, ``wo (H, hd, D)``, the
reference's layouts. Scores are divided by sqrt(hd), causally masked and
soft-maxed in fp32. Sequences up to ``DIRECT_ATTN_MAX_SEQ`` keys take the
masked-einsum path, longer ones the chunked online softmax. Decode writes
one slot of a full cache or of a ring buffer (``window`` > 0) in place.

MLA keeps a rank-r latent ``ckv`` and one shared RoPE key ``krope`` (rh)
per position: ``w_dkv (D, r+rh)``, ``w_uk (r, H, hd)``, ``w_uv (r, H,
vh)``, ``wo (H, vh, D)``, and the query through ``w_dq (D, qr)`` and
``w_uq (qr, H, hd+rh)``, or ``wq (D, H, hd+rh)`` without a query rank.
The full sequence materializes per-head keys (qk dim hd+rh) and values
(vh); decode attends in the latent space with W_uk absorbed into the
query, in fp32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import (NEG_INF, Init, ModelConfig, Params,
                                       apply_rope, attention_core,
                                       cache_write, dense_init)

# KV-block size for the chunked online-softmax path.
KV_CHUNK = 1024
# Sequences at or below this use the plain masked-einsum path.
DIRECT_ATTN_MAX_SEQ = 4096
# key position of an empty cache slot or a padded key: never <= a query's
INT_MAX = torch.iinfo(torch.int32).max


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


def init_mla(init: Init, cfg: ModelConfig) -> Params:
    """DeepSeek-V2 Multi-head Latent Attention params."""
    d, h = cfg.d_model, cfg.n_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    hd, rh = cfg.hd, cfg.rope_head_dim
    vh = cfg.v_head_dim or hd
    dt = cfg.param_dtype
    p = {"w_dkv": dense_init(init, (d, r + rh), dt),
         "w_uk": dense_init(init, (r, h, hd), dt, fan_in=r),
         "w_uv": dense_init(init, (r, h, vh), dt, fan_in=r),
         "wo": dense_init(init, (h, vh, d), dt, fan_in=h * vh)}
    if qr > 0:
        p["w_dq"] = dense_init(init, (d, qr), dt)
        p["w_uq"] = dense_init(init, (qr, h, hd + rh), dt, fan_in=qr)
    else:
        p["wq"] = dense_init(init, (d, h, hd + rh), dt)
    return p


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Sq,H,hd), k (B,Sk,KV,hd) -> scores (B,KV,G,Sq,Sk), H = KV*G.
    fp32 out, as the reference's ``preferred_element_type``: bf16
    operands are upcast (their products are exact in fp32)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    return torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B,KV,G,Sq,Sk), v (B,Sk,KV,hd) -> (B,Sq,H,hd), fp32."""
    b, kvh, g, sq, _ = probs.shape
    o = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return o.reshape(b, sq, kvh * g, v.shape[-1])


def _mask(q_pos, k_pos, window: int) -> torch.Tensor:
    """(Sq, Sk): key k_pos visible from q_pos."""
    mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask = mask & (k_pos[None, :] > (q_pos[:, None] - window))
    return mask


def direct_attention(q, k, v, q_pos, k_pos, window: int = 0
                     ) -> torch.Tensor:
    """Masked-einsum attention; fine up to a few thousand tokens."""
    hd = q.shape[-1]
    scores = _gqa_scores(q, k) / math.sqrt(hd)
    mask = _mask(q_pos, k_pos, window)
    scores = torch.where(mask[None, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v).to(q.dtype)


def chunked_attention(q, k, v, q_pos, k_pos, window: int = 0,
                      chunk: int = KV_CHUNK) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash-style, a loop over
    the chunks): never materializes (Sq, Sk). The last chunk is padded
    with keys at position INT_MAX, which the causal mask drops."""
    b, sq, h, hd = q.shape
    vd = v.shape[-1]
    sk = k.shape[1]
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=INT_MAX)
    kvh = k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, vd), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = _gqa_scores(q, k[:, sl]) * scale              # (B,KV,G,Sq,chunk)
        mask = _mask(q_pos, k_pos[sl], window)
        s = torch.where(mask[None, None, None], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)                      # rescale old acc
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = _gqa_out(p, v[:, sl])                         # (B,Sq,H,vd)
        scale_o = alpha.permute(0, 3, 1, 2).reshape(b, sq, h)[..., None]
        acc = acc * scale_o + o
        m = m_new
    denom = l.permute(0, 3, 1, 2).reshape(b, sq, h)[..., None]
    return (acc / torch.clamp(denom, min=1e-30)).to(q.dtype)


def attention_any(q, k, v, q_pos, k_pos, window: int = 0) -> torch.Tensor:
    if k.shape[1] <= DIRECT_ATTN_MAX_SEQ:
        return direct_attention(q, k, v, q_pos, k_pos, window)
    return chunked_attention(q, k, v, q_pos, k_pos, window)


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
                 positions: torch.Tensor, window: int = 0,
                 return_kv: bool = False):
    """Full-sequence causal attention. positions: (S,) int32. With
    ``return_kv`` also the roped keys and the values, (B,S,KV,hd) each."""
    q, k, v = _qkv(p, cfg, x, positions)
    o = attention_core(attention_any, q, k, v, positions, positions, window)
    y = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])
    if return_kv:
        return y, (k, v)
    return y


def attn_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params,
                window: int = 0):
    """One-token decode. x (B,1,D); cache {'k','v': (B,S,KV,hd),
    'k_pos': (S,) int32, 'pos': () int32}, updated in place (its tensors
    may be views of a stack over layer groups) and returned.

    The new key goes to slot ``pos % S`` of a ring buffer (``window`` >
    0, S = the window) and to slot ``min(pos, S - 1)`` of a full cache,
    which past its capacity overwrites the last slot, as the reference
    does. ``pos`` stays on the device: no host sync per layer."""
    pos = cache["pos"]
    positions = pos.reshape(1)
    q, k1, v1 = _qkv(p, cfg, x, positions)
    s_cache = cache["k"].shape[1]
    slot = pos % s_cache if window > 0 else torch.clamp(pos, max=s_cache - 1)
    slot = slot.reshape(1).long()
    for name, new in (("k", k1), ("v", v1)):
        cache_write(cache[name], 1, slot, new.to(cache[name].dtype))
    cache_write(cache["k_pos"], 0, slot, positions)
    o = attention_core(direct_attention, q, cache["k"], cache["v"],
                       positions, cache["k_pos"], window)
    y = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])
    pos.add_(1)                    # after every read of the old position
    return y, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): full sequence + absorbed decode
# ---------------------------------------------------------------------------

def _mla_q(p: Params, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor):
    """(q_nope (B,S,H,hd), q_rope (B,S,H,rh) roped)."""
    if cfg.q_lora_rank > 0:
        cq = torch.einsum("bsd,dr->bsr", x, p["w_dq"])
        q = torch.einsum("bsr,rhk->bshk", cq, p["w_uq"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    hd = cfg.hd
    return q[..., :hd], apply_rope(q[..., hd:], positions, cfg.rope_theta)


def _mla_latent(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """(ckv (B,S,r), krope (B,S,rh) roped)."""
    r = cfg.kv_lora_rank
    dkv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"])      # (B,S,r+rh)
    krope = apply_rope(dkv[..., None, r:], positions, cfg.rope_theta)
    return dkv[..., :r], krope[:, :, 0]


def mla_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, return_kv: bool = False):
    """Full-sequence MLA: per-head keys and values materialized from the
    latent, the shared RoPE key broadcast over the heads. With
    ``return_kv`` also (ckv (B,S,r), krope (B,S,rh)) in x's dtype, the
    decode cache's contents."""
    ckv, krope = _mla_latent(p, cfg, x, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["w_uk"])  # (B,S,H,hd)
    v = torch.einsum("bsr,rhk->bshk", ckv, p["w_uv"])       # (B,S,H,vh)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    k_full = torch.cat([k_nope, krope[:, :, None, :].expand(
        *k_nope.shape[:3], krope.shape[-1])], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    o = attention_core(attention_any, q_full, k_full, v, positions,
                       positions)
    y = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])
    if return_kv:
        return y, (ckv.to(x.dtype), krope.to(x.dtype))
    return y


def mla_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params):
    """Absorbed-matmul MLA decode in the rank-r latent space. cache
    {'ckv': (B,S,r), 'krope': (B,S,rh), 'k_pos': (S,), 'pos': ()},
    updated in place and returned. The new position goes to slot
    ``min(pos, S - 1)``, as in ``attn_decode``. Scores are q_eff·ckv +
    q_rope·krope over sqrt(hd + rh), with q_eff = q_nope W_uk per head,
    and the output o_lat W_uv: all in fp32, the per-head K and V never
    materialized."""
    rh, hd = cfg.rope_head_dim, cfg.hd
    pos = cache["pos"]
    positions = pos.reshape(1)
    ckv1, krope1 = _mla_latent(p, cfg, x, positions)
    slot = torch.clamp(pos, max=cache["ckv"].shape[1] - 1).reshape(1).long()
    for name, new in (("ckv", ckv1), ("krope", krope1)):
        cache_write(cache[name], 1, slot, new.to(cache[name].dtype))
    cache_write(cache["k_pos"], 0, slot, positions)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)          # (B,1,H,hd/rh)
    q_eff = torch.einsum("bshk,rhk->bshr", q_nope.float(),
                         p["w_uk"].float())                 # (B,1,H,r)
    ckv = cache["ckv"].float()
    scores = (torch.einsum("bshr,btr->bhst", q_eff, ckv)
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             cache["krope"].float()))
    scores = scores / math.sqrt(hd + rh)
    mask = _mask(positions, cache["k_pos"], 0)              # (1,S)
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)                   # (B,H,1,S)
    o_lat = torch.einsum("bhst,btr->bshr", probs, ckv)
    o = torch.einsum("bshr,rhk->bshk", o_lat, p["w_uv"].float())
    y = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])
    pos.add_(1)                    # after every read of the old position
    return y, cache
