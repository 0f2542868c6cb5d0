"""Decode caches for every mixer kind the port runs.

Cache trees mirror the parameter tree: ``{"groups": {pos_i: stacked
(G, ...)}, "rem": [per-layer]}``, the reference's layout, so caches cross
to and from it (``repro_torch.convert``). Kinds:

  global -> full KV          {'k','v': (B,S,KV,hd), 'k_pos': (S,), 'pos': ()}
  local  -> ring buffer      same but S == min(window, max_seq)
  mla    -> compressed       {'ckv': (B,S,r), 'krope': (B,S,rh), 'k_pos', 'pos'}
  ssd    -> SSM state        {'state': (B,H,P,N), 'conv': (B,cw-1,C)}
  rec    -> RG-LRU state     {'state': (B,W), 'conv': (B,cw-1,W)}

``k_pos`` and ``pos`` are int32; an empty slot's ``k_pos`` is INT_MAX,
which the causal mask drops. The decode step updates a cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import INT_MAX
from repro_torch.models.common import ModelConfig, Params, tree_map
from repro_torch.models.rglru import rglru_init_cache
from repro_torch.models.ssm import ssd_init_cache

__all__ = ["INT_MAX", "cache_window", "full_kv_to_cache", "init_cache",
           "layer_cache", "mla_kv_to_cache"]


def layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                dtype, device=None) -> Params:
    if kind == "ssd":
        return ssd_init_cache(cfg, batch, dtype, device)
    if kind == "rec":
        return rglru_init_cache(cfg, batch, dtype, device)
    if kind == "mla":
        r, rh = cfg.kv_lora_rank, cfg.rope_head_dim
        return {
            "ckv": torch.zeros((batch, max_seq, r), dtype=dtype,
                               device=device),
            "krope": torch.zeros((batch, max_seq, rh), dtype=dtype,
                                 device=device),
            "k_pos": torch.full((max_seq,), INT_MAX, dtype=torch.int32,
                                device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device),
        }
    s = cache_window(cfg, kind, max_seq)
    kv, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((batch, s, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, s, kv, hd), dtype=dtype, device=device),
        "k_pos": torch.full((s,), INT_MAX, dtype=torch.int32, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> Params:
    """Empty cache tree for the whole stack (pos=0)."""
    dtype = dtype or cfg.param_dtype
    pattern = cfg.layer_pattern
    groups = {}
    for i, kind in enumerate(pattern):
        one = layer_cache(cfg, kind, batch, max_seq, dtype, device)
        groups[f"pos{i}"] = tree_map(
            lambda x: x[None].expand(cfg.n_groups, *x.shape).contiguous(),
            one)
    rem = [layer_cache(cfg, pattern[i], batch, max_seq, dtype, device)
           for i in range(cfg.n_remainder)]
    return {"groups": groups, "rem": rem}


def cache_window(cfg: ModelConfig, kind: str, max_seq: int) -> int:
    """Sequence capacity of a given layer kind's cache."""
    if kind == "local":
        return min(cfg.sliding_window, max_seq)
    if kind in ("global", "mla"):
        return max_seq
    return 0


def _positions(s: int, max_seq: int, dev) -> torch.Tensor:
    """k_pos of a cache primed with positions 0..s-1: (max_seq,) int32."""
    kp = torch.full((max_seq,), INT_MAX, dtype=torch.int32, device=dev)
    kp[:s] = torch.arange(s, dtype=torch.int32, device=dev)
    return kp


def full_kv_to_cache(k: torch.Tensor, v: torch.Tensor, max_seq: int,
                     window: int = 0) -> Params:
    """Pack prefill K/V (B,S,KV,hd) into a decode cache of capacity
    max_seq, or into a ring buffer of ``min(window, max_seq)`` slots:
    position t lands in slot t % w, so a prompt longer than the window
    keeps its last w positions."""
    b, s, kvh, hd = k.shape
    dev = k.device
    pos = torch.tensor(s, dtype=torch.int32, device=dev)
    if window > 0:
        w = min(window, max_seq)
        pos_idx = torch.arange(max(0, s - w), s, device=dev)
        slots = pos_idx % w
        if s <= w:              # position t in slot t, the rest zeros
            ck = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, w - s))
            cv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, w - s))
        else:                   # the last w positions, t in slot t % w
            r = w - s % w
            ck = torch.cat([k[:, s - w + r:], k[:, s - w:s - w + r]], dim=1)
            cv = torch.cat([v[:, s - w + r:], v[:, s - w:s - w + r]], dim=1)
        kp = torch.full((w,), INT_MAX, dtype=torch.int32, device=dev)
        kp[slots] = pos_idx.to(torch.int32)
        return {"k": ck, "v": cv, "k_pos": kp, "pos": pos}
    pad = max_seq - s
    return {"k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
            "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)),
            "k_pos": _positions(s, max_seq, dev), "pos": pos}


def mla_kv_to_cache(ckv: torch.Tensor, krope: torch.Tensor,
                    max_seq: int) -> Params:
    """Pack prefill latents ckv (B,S,r) and krope (B,S,rh) into an MLA
    decode cache of capacity max_seq."""
    s = ckv.shape[1]
    dev = ckv.device
    pad = max_seq - s
    return {"ckv": torch.nn.functional.pad(ckv, (0, 0, 0, pad)),
            "krope": torch.nn.functional.pad(krope, (0, 0, 0, pad)),
            "k_pos": _positions(s, max_seq, dev),
            "pos": torch.tensor(s, dtype=torch.int32, device=dev)}
