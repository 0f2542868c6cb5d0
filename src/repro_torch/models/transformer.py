"""The layer-group decoder stack for every assigned architecture.

Params keep the reference's tree: per-position layer params stacked over
the ``cfg.n_groups`` repeats of ``cfg.layer_pattern`` under
``groups/pos{i}``, plus a ``rem`` list for the ``n_layers % |pattern|``
remainder layers. The reference scans over the groups; here a Python
loop runs each group's slice. Caches share the layout (``cache.py``).

Three entry points:
  forward(...)      full-sequence logits and the MoE aux loss
  prefill(...)      full-sequence logits + a primed decode cache
  decode_step(...)  one token against the cache, updated in place

and the training loss, ``lm_loss`` (``token_ce_loss`` plus the weighted
MoE aux loss), whose ``remat=True`` recomputes each layer group (and
each remainder layer) in the backward pass, as the reference's
``jax.checkpoint`` does.

``moe_path`` picks the MoE FFN's full-sequence path ("gshard", the
reference's default, or "dropless"); decode runs ``moe_decode``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import Device, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.cache import full_kv_to_cache, mla_kv_to_cache
from repro_torch.models.common import (Init, ModelConfig, Params, dense_init,
                                       embed_init, embed_rows, init_rmsnorm,
                                       local_core, pick_logits, pin,
                                       rmsnorm)
from repro_torch.tree import tree_leaves, tree_unflatten
from repro_torch.models.frontends import frontend_dim


# ---------------------------------------------------------------------------
# ZeRO-3 layer-weight gather hook
# ---------------------------------------------------------------------------
# Under the FSDP sharding policy (the dry run), expert weights are STORED
# data-sharded; the hook redistributes each layer group's slice back to
# its tensor-parallel layout at use, inside the group's activation
# checkpoint, so one group's gathered weights are live at a time.
_LAYER_PARAM_HOOK = None


def set_layer_param_hook(fn) -> None:
    """fn(group_params_dict) -> the dict to run the group with, or None to
    disable."""
    global _LAYER_PARAM_HOOK
    _LAYER_PARAM_HOOK = fn


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------

def init_layer(init: Init, cfg: ModelConfig, kind: str) -> Params:
    p: Dict[str, Any] = {"norm1": init_rmsnorm(init, cfg.d_model,
                                               cfg.param_dtype)}
    if kind in ("global", "local"):
        p["mixer"] = attn.init_attention(init, cfg)
    elif kind == "mla":
        p["mixer"] = attn.init_mla(init, cfg)
    elif kind == "ssd":
        p["mixer"] = ssm_mod.init_ssd(init, cfg)
    elif kind == "rec":
        p["mixer"] = rglru_mod.init_rglru(init, cfg)
    else:
        raise ValueError(f"unknown mixer kind {kind!r}")
    if cfg.d_ff > 0:
        p["norm2"] = init_rmsnorm(init, cfg.d_model, cfg.param_dtype)
        p["ffn"] = (ffn_mod.init_moe(init, cfg) if cfg.is_moe
                    else ffn_mod.init_dense_ffn(init, cfg))
    return p


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.sliding_window if kind == "local" else 0


def _apply_ffn(p: Params, cfg: ModelConfig, x: torch.Tensor,
               moe_path: Optional[str]):
    """(x + FFN(norm2(x)), MoE aux loss or None); ``moe_path`` None is
    the decode path."""
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    aux = None
    if not cfg.is_moe:
        y = ffn_mod.dense_ffn(p["ffn"], h)
    elif moe_path is None:
        y, _ = ffn_mod.moe_decode(p["ffn"], cfg, h)
    else:
        y, aux = ffn_mod.moe_forward(p["ffn"], cfg, h, path=moe_path)
    return pin(x + y), aux


def apply_layer(p: Params, cfg: ModelConfig, kind: str, x: torch.Tensor,
                positions: torch.Tensor, moe_path: str = "gshard",
                cache_seq: int = 0):
    """Full-sequence layer. Returns (x, MoE aux loss or None, cache or
    None): the layer's decode cache of capacity ``cache_seq`` when that
    is > 0."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    want = cache_seq > 0
    cache = None
    if kind in ("global", "local"):
        y = attn.attn_forward(p["mixer"], cfg, h, positions,
                              _window(cfg, kind), return_kv=want)
        if want:
            y, (k, v) = y
            cache = local_core(full_kv_to_cache, k, v, cache_seq,
                               _window(cfg, kind))
    elif kind == "mla":
        y = attn.mla_forward(p["mixer"], cfg, h, positions, return_kv=want)
        if want:
            y, (ckv, krope) = y
            cache = local_core(mla_kv_to_cache, ckv, krope, cache_seq)
    elif kind == "ssd":
        y = ssm_mod.ssd_forward(p["mixer"], cfg, h, return_state=want)
    elif kind == "rec":
        y = rglru_mod.rglru_forward(p["mixer"], cfg, h, return_state=want)
    else:
        raise ValueError(kind)
    if want and cache is None:
        y, cache = y
    x = pin(x + y)
    aux = None
    if cfg.d_ff > 0:
        x, aux = _apply_ffn(p, cfg, x, moe_path)
    return x, aux, cache


def apply_layer_decode(p: Params, cfg: ModelConfig, kind: str,
                       x: torch.Tensor, cache: Params) -> torch.Tensor:
    """One-token layer step; updates ``cache`` in place."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind in ("global", "local"):
        y, _ = attn.attn_decode(p["mixer"], cfg, h, cache, _window(cfg, kind))
    elif kind == "mla":
        y, _ = attn.mla_decode(p["mixer"], cfg, h, cache)
    elif kind == "ssd":
        y, _ = ssm_mod.ssd_decode(p["mixer"], cfg, h, cache)
    elif kind == "rec":
        y, _ = rglru_mod.rglru_decode(p["mixer"], cfg, h, cache)
    else:
        raise ValueError(kind)
    x = pin(x + y)
    if cfg.d_ff > 0:
        x, _ = _apply_ffn(p, cfg, x, None)
    return x


# ---------------------------------------------------------------------------
# whole-stack init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, device: Device = None,
                generator: Optional[torch.Generator] = None) -> Params:
    """One model's params on ``device`` (None: the card), drawn from
    ``generator``: the reference's initializers and tree, not its draws
    (threefry); the tests carry the reference's own params across
    (``repro_torch.convert.lm_tree_from_numpy``)."""
    dev = resolve_device(device)
    one = Init(None, dev, generator)
    p: Dict[str, Any] = {
        "embed": embed_init(one, (cfg.vocab_size, cfg.d_model),
                            cfg.param_dtype),
        "final_norm": init_rmsnorm(one, cfg.d_model, cfg.param_dtype),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(one, (cfg.d_model, cfg.vocab_size),
                                  cfg.param_dtype)
    if cfg.frontend is not None:
        p["frontend_proj"] = dense_init(
            one, (frontend_dim(cfg.frontend), cfg.d_model), cfg.param_dtype)
    stacked = Init(cfg.n_groups, dev, generator)
    p["groups"] = {f"pos{i}": init_layer(stacked, cfg, kind)
                   for i, kind in enumerate(cfg.layer_pattern)}
    p["rem"] = [init_layer(one, cfg, cfg.layer_pattern[i])
                for i in range(cfg.n_remainder)]
    return p


def abstract_params(cfg: ModelConfig) -> Params:
    """The params tree on the ``meta`` device: shapes and dtypes, no
    storage (the dry run's)."""
    return init_params(cfg, device="meta")


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_inputs(params: Params, cfg: ModelConfig,
                 tokens: Optional[torch.Tensor],
                 embeds: Optional[torch.Tensor]) -> torch.Tensor:
    parts = []
    if embeds is not None:
        parts.append(torch.einsum("bse,ed->bsd", embeds.to(cfg.param_dtype),
                                  params["frontend_proj"]))
    if tokens is not None:
        parts.append(embed_rows(params["embed"], tokens))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    # sqrt(d_model) in fp32, rounded to x's dtype before the multiply (the
    # reference's order: in bf16, sqrt(896) is 29.875); a Python scalar,
    # so no host-to-device copy (and sync) per step
    scale = torch.tensor(np.sqrt(np.float32(cfg.d_model))).to(x.dtype)
    return pin(x * float(scale))


def lm_logits(params: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    """fp32 logits (B,S,V). The reference's bf16 head product returns fp32
    (``preferred_element_type``); here both operands are upcast, so a bf16
    head is copied to fp32 on every call (qwen2-0.5b's tied 151936 x 896
    head: 545 MB written and read again a decode step)."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x.float(), head.float())


# ---------------------------------------------------------------------------
# forward / prefill / decode
# ---------------------------------------------------------------------------

def _groups(tree, n_groups: int) -> List:
    """Every group's slice of a tree stacked over groups: one ``unbind``
    a leaf (views), whose backward stacks the groups' grads once, where
    ``n_groups`` slices would each backpropagate a zero-filled grad of
    the whole stack."""
    if n_groups == 0:
        return []
    per_leaf = [t.unbind(0) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, [s[g] for s in per_leaf])
            for g in range(n_groups)]


def _stack(trees: List) -> Params:
    if not trees:
        return {}
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _run_stack(params: Params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, moe_path: str, cache_seq: int,
               remat: bool = False):
    """Every layer over the full sequence: (x, aux, group caches, rem
    caches); aux is the layers' MoE aux losses summed in fp32, in stack
    order. ``remat`` runs each group's whole pattern, and each remainder
    layer, under one activation checkpoint (recomputed in the backward
    pass; the stack draws nothing random, so no RNG state is kept). The
    layer-param hook, when set, maps each group's slice inside it, as the
    reference's scan body does (remainder layers are not mapped)."""
    pattern = cfg.layer_pattern

    def layers(units, x, aux):
        caches = []
        for p, kind in units:
            x, a, c = apply_layer(p, cfg, kind, x, positions, moe_path,
                                  cache_seq)
            if a is not None:
                aux = aux + a
            caches.append(c)
        return x, aux, caches

    def group(gp, x, aux):
        if _LAYER_PARAM_HOOK is not None:
            gp = _LAYER_PARAM_HOOK(gp)
        return layers([(gp[f"pos{i}"], kind)
                       for i, kind in enumerate(pattern)], x, aux)

    def run(fn, units, x, aux):
        if remat:
            return checkpoint(fn, units, x, aux, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(units, x, aux)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    group_caches: List[Params] = []
    for gp in _groups(params["groups"], cfg.n_groups):
        x, aux, caches = run(group, gp, x, aux)
        group_caches.append({f"pos{i}": c for i, c in enumerate(caches)})
    rem_caches = []
    for i, p in enumerate(params["rem"]):
        x, aux, (c,) = run(layers, [(p, pattern[i])], x, aux)
        rem_caches.append(c)
    return x, aux, group_caches, rem_caches


def forward(params: Params, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            moe_path: str = "gshard", remat: bool = False):
    """Returns (logits (B,S,V) fp32, aux loss () fp32): the sum of the
    MoE layers' load-balance terms, 0 without experts. ``remat=True``
    checkpoints each layer group and each remainder layer (activations
    recomputed in the backward pass)."""
    x = embed_inputs(params, cfg, tokens, embeds)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
    x, aux, _, _ = _run_stack(params, cfg, x, positions, moe_path, 0, remat)
    return lm_logits(params, cfg, x), aux


def prefill(params: Params, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            cache_seq: int = 0, moe_path: str = "gshard"):
    """Full-sequence forward that also primes a decode cache of capacity
    ``cache_seq`` (>= prompt length). Returns (logits, cache); the MoE
    aux loss is dropped, as the reference's is."""
    x = embed_inputs(params, cfg, tokens, embeds)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    x, _, group_caches, rem = _run_stack(params, cfg, x, positions,
                                         moe_path, max(cache_seq, s))
    cache = {"groups": _stack(group_caches), "rem": rem}
    return lm_logits(params, cfg, x), cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params):
    """token (B,1) int -> (logits (B,1,V) fp32, cache). The cache is
    updated in place and returned: the reference's step returns a new
    one, and a caller that needs the old cache keeps a copy."""
    x = embed_inputs(params, cfg, token, None)
    pattern = cfg.layer_pattern
    for gp, gc in zip(_groups(params["groups"], cfg.n_groups),
                      _groups(cache["groups"], cfg.n_groups)):
        for i, kind in enumerate(pattern):
            x = apply_layer_decode(gp[f"pos{i}"], cfg, kind, x,
                                   gc[f"pos{i}"])
    for i, p in enumerate(params["rem"]):
        x = apply_layer_decode(p, cfg, pattern[i], x, cache["rem"][i])
    return lm_logits(params, cfg, x), cache


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def token_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy, logits (B,S,V) fp32, labels (B,S):
    logsumexp minus the label's logit (a gather picks what the
    reference's one-hot contraction picks). With a mask, the masked mean
    ``-sum(ll m) / max(sum m, 1)``."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = pin(pick_logits(logits, labels))
    ll = picked - lse
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def lm_loss(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], moe_path: str = "gshard",
            aux_weight: float = 0.01, remat: bool = False):
    """(ce + aux_weight * aux, (ce, aux)) of ``batch`` ({tokens, labels}
    and optionally embeds and a mask). When the logits are longer than
    the labels (a frontend's frames first), the loss takes the text
    tail."""
    logits, aux = forward(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"), moe_path=moe_path,
                          remat=remat)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1]:]
    loss = token_ce_loss(logits, labels, batch.get("mask"))
    return loss + aux_weight * aux, (loss, aux)
