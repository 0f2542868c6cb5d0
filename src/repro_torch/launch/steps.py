"""The three step functions: train_step, prefill_step and serve_step.

Functions of (params[, opt_state], inputs) with the config and the
optimizer closed over, as the reference's.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import ModelConfig, pin
from repro_torch.models.transformer import decode_step, lm_loss, prefill
from repro_torch.optim import (Optimizer, apply_updates,
                               clip_tree_by_global_norm)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def lm_value_and_grad(params, cfg: ModelConfig,
                      batch: Dict[str, torch.Tensor],
                      moe_path: str = "gshard", remat: bool = False):
    """``lm_loss`` and its gradient: (loss, ce, aux, grads), the grads a
    list in ``tree_leaves(params)`` order in the params' dtypes (zeros
    for a leaf the loss does not reach, as ``jax.grad`` gives)."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        loss, (ce, aux) = lm_loss(tree_unflatten(params, leaves), cfg,
                                  batch, moe_path=moe_path, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # each grad in its param's layout (the dry run's partitioner: a
    # data-parallel grad is all-reduced, as GSPMD lays it out)
    grads = [torch.zeros_like(t) if g is None else pin(g, t)
             for t, g in zip(leaves, grads)]
    return loss.detach(), ce.detach(), aux.detach(), grads


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    moe_path: str = "gshard", remat: bool = True,
                    clip_norm: float = 1.0, microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``optimizer`` is a ``single_model`` one (trees, a 0-d step). The
    grads of ``lm_loss`` are clipped to a global norm of ``clip_norm``,
    then the optimizer's updates are applied; new params and state come
    back, the old ones are left as they were. Metrics are 0-d tensors:
    ``loss``, ``ce``, ``moe_aux`` and ``gnorm`` (the norm before the
    clip). The step changes no global setting: with TF32 matmuls on, a
    MoE config's ``route`` raises on the card.

    ``microbatches=K > 1`` accumulates gradients, as the reference's scan
    does: microbatch j holds the batch's rows j, j+K, j+2K, ... (a
    ``(B/K, K, ...)`` reshape, then K moved to the front; contiguous
    chunks would change GShard's capacity and routing); the grads are
    summed into fp32 zeros, so the clip and the update see fp32 grads
    even for bf16 params (with K = 1 they see the params' dtype); the
    loss, ce, aux and grads are sums scaled by 1/K."""

    @torch.no_grad()
    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if microbatches > 1:
            k = microbatches
            leaves = tree_leaves(params)
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            loss, ce, aux = (torch.zeros((), device=leaves[0].device)
                             for _ in range(3))
            for j in range(k):
                mb = tree_map(lambda x: x.reshape(x.shape[0] // k, k,
                                                  *x.shape[1:])[:, j], batch)
                l, c, a, g = lm_value_and_grad(params, cfg, mb, moe_path,
                                               remat)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                loss, ce, aux = loss + l, ce + c, aux + a
            scale = 1.0 / k
            loss, ce, aux = loss * scale, ce * scale, aux * scale
            grads = [g * scale for g in grads]
        else:
            loss, ce, aux, grads = lm_value_and_grad(params, cfg, batch,
                                                     moe_path, remat)
        grads, gnorm = clip_tree_by_global_norm(
            tree_unflatten(params, grads), clip_norm)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        metrics = {"loss": loss, "ce": ce, "moe_aux": aux, "gnorm": gnorm}
        return params, opt_state, metrics

    return train_step


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
