"""Optimizers over a cohort's stacked params: SGD (+momentum), Adam and
AdamW, with global-norm clipping.

The reference's (init, update) contract, written for stacked tensors:
``update`` maps (grads, state, params) -> (updates, state) and
``apply_updates`` adds the updates. Every param carries its clients on a
leading axis, so the step counter is per client (``(n_c,)`` int32) and
whatever depends on it (a scheduled lr, Adam's bias corrections) is
broadcast over each leaf's client rows. Moments are fp32 whatever the
param dtype. ``lr`` is a float or a callable of the step tensor; like the
reference, an update reads the lr at the old step and Adam's moments at
the new one.

``single_model`` gives any of them the reference's one-model form, as
the LM trainer uses it: params, grads, updates and moments are trees
(nested dicts and lists, ``repro_torch.tree``), the step counter is 0-d
and ``clip_tree_by_global_norm`` takes one norm over every leaf. The
arithmetic is the cohort form's. Adam builds new moment and update
tensors each step, so at its peak a step holds the params, the grads,
the old and new fp32 moments and the fp32 updates: 24 bytes a bf16
param (qwen2-0.5b's 494 M: 11.9 GB).
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.tree import tree_leaves, tree_unflatten

Tensors = Sequence[torch.Tensor]
Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tensors], NamedTuple]
    update: Callable[..., Tuple[List[torch.Tensor], NamedTuple]]


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-client ``(n_c,)`` tensor shaped to broadcast over ``like``;
    one model's 0-d value as it is."""
    if v.dim() == 0:
        return v
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    """The lr at ``step`` as an fp32 ``(n_c,)`` tensor on the step's
    device (a float lr is the same for every client, filled in place:
    a host-to-card copy of it would synchronize every step)."""
    if callable(lr):
        return torch.as_tensor(lr(step), dtype=torch.float32,
                               device=step.device).expand(step.shape)
    return torch.full(step.shape, lr, dtype=torch.float32,
                      device=step.device)


def apply_updates(params, updates):
    """``params + updates`` leaf for leaf, in the params' dtypes: lists
    of tensors, or trees of one structure (the result has the params')."""
    return tree_unflatten(params, [
        (p + u.to(p.dtype)).to(p.dtype)
        for p, u in zip(tree_leaves(params), tree_leaves(updates))])


def _clip(grads: Tensors, max_norm: float, sum_squares: Callable):
    gn = torch.sqrt(sum(sum_squares(torch.square(g.float())) for g in grads))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return [g * _rows(scale, g).to(g.dtype) for g in grads], gn


def clip_by_global_norm(grads: Tensors, max_norm: float):
    """Scale each client's gradients so that their global norm over all
    leaves is at most ``max_norm``; returns (clipped, per-client norm
    ``(n_c,)``), the reference's function under its per-client vmap."""
    return _clip(grads, max_norm,
                 lambda sq: torch.sum(sq.reshape(sq.shape[0], -1), dim=1))


def clip_tree_by_global_norm(grads, max_norm: float):
    """One model's gradient tree scaled so that its global norm over
    every leaf is at most ``max_norm``: the reference's function. The
    squares are summed leaf by leaf in ``jax.tree.leaves`` order, and the
    scale is cast to each leaf's dtype before the multiply (a bf16 leaf
    is scaled by the bf16-rounded scale). Returns (clipped tree, norm
    0-d fp32). A leading axis (a layer group's, the vocab's) is summed
    over like any other."""
    leaves, gn = _clip(tree_leaves(grads), max_norm, torch.sum)
    return tree_unflatten(grads, leaves), gn


def state_tensors(state) -> List[torch.Tensor]:
    """Every tensor of an optimizer state (step counter and moments)."""
    out: List[torch.Tensor] = []
    for field in state:
        if isinstance(field, torch.Tensor):
            out.append(field)
        elif field is not None:
            out.extend(field)
    return out


def single_model(optimizer: Optimizer) -> Optimizer:
    """The reference's one-model form of ``optimizer`` (``adam``, ``sgd``,
    ...): ``init(params)`` and ``update(grads, state, params=None)`` take
    trees, the state holds a 0-d int32 step and its moments as trees
    shaped like the params, and the updates come back as a tree. The
    same update arithmetic as the cohort form, with 0-d lr and bias
    corrections."""

    def as_leaves(state):
        return type(state)(*[
            f if f is None or isinstance(f, torch.Tensor) else tree_leaves(f)
            for f in state])

    def as_trees(state, like):
        return type(state)(*[
            f if f is None or isinstance(f, torch.Tensor)
            else tree_unflatten(like, f) for f in state])

    def init(params):
        state = optimizer.init(tree_leaves(params))
        return as_trees(state._replace(step=state.step.new_zeros(())), params)

    def update(grads, state, params=None):
        updates, new = optimizer.update(
            tree_leaves(grads), as_leaves(state),
            None if params is None else tree_leaves(params))
        return tree_unflatten(grads, updates), as_trees(new, grads)

    return Optimizer(init, update)


def _step0(params: Tensors) -> torch.Tensor:
    return torch.zeros((params[0].shape[0],), dtype=torch.int32,
                       device=params[0].device)


def _zeros(params: Tensors) -> List[torch.Tensor]:
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


# ---------------------------------------------------------------------------
# SGD (+momentum)
# ---------------------------------------------------------------------------

class SGDState(NamedTuple):
    step: torch.Tensor                        # (n_c,) int32
    momentum: Optional[List[torch.Tensor]]    # fp32 per param; None at 0


def sgd(lr: Schedule, momentum: float = 0.0) -> Optimizer:
    def init(params):
        return SGDState(step=_step0(params),
                        momentum=_zeros(params) if momentum else None)

    def update(grads, state, params=None):
        lr_t = _lr_at(lr, state.step)
        if momentum:
            mom = [momentum * m + g.float()
                   for m, g in zip(state.momentum, grads)]
            return ([-_rows(lr_t, m) * m for m in mom],
                    SGDState(state.step + 1, mom))
        return ([-_rows(lr_t, g) * g.float() for g in grads],
                SGDState(state.step + 1, None))

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adam / AdamW
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: torch.Tensor                 # (n_c,) int32
    mu: List[torch.Tensor]             # fp32 first moments
    nu: List[torch.Tensor]             # fp32 second moments


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return AdamState(step=_step0(params), mu=_zeros(params),
                         nu=_zeros(params))

    def update(grads, state, params=None):
        step = state.step + 1
        lr_t = _lr_at(lr, state.step)
        mu = [b1 * m + (1 - b1) * g.float() for m, g in zip(state.mu, grads)]
        nu = [b2 * v + (1 - b2) * torch.square(g.float())
              for v, g in zip(state.nu, grads)]
        # per-client bias corrections, (n_c,) fp32
        bc1 = 1 - torch.pow(b1, step.float())
        bc2 = 1 - torch.pow(b2, step.float())
        if weight_decay and params is None:
            raise ValueError("adam with weight_decay needs params")
        updates = []
        for i, (m, v) in enumerate(zip(mu, nu)):
            u = (-_rows(lr_t, m) * (m / _rows(bc1, m))
                 / (torch.sqrt(v / _rows(bc2, v)) + eps))
            if weight_decay:
                u = u - _rows(lr_t * weight_decay, u) * params[i].float()
            updates.append(u)
        return updates, AdamState(step, mu, nu)

    return Optimizer(init, update)


def adamw(lr: Schedule, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)
