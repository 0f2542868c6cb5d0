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
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch

Tensors = Sequence[torch.Tensor]
Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tensors], NamedTuple]
    update: Callable[..., Tuple[List[torch.Tensor], NamedTuple]]


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-client ``(n_c,)`` tensor shaped to broadcast over ``like``."""
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


def apply_updates(params: Tensors, updates: Tensors) -> List[torch.Tensor]:
    return [(p + u.to(p.dtype)).to(p.dtype) for p, u in zip(params, updates)]


def clip_by_global_norm(grads: Tensors, max_norm: float):
    """Scale each client's gradients so that their global norm over all
    leaves is at most ``max_norm``; returns (clipped, per-client norm
    ``(n_c,)``), the reference's function under its per-client vmap."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()).reshape(
        g.shape[0], -1), dim=1) for g in grads))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return [g * _rows(scale, g).to(g.dtype) for g in grads], gn


def state_tensors(state) -> List[torch.Tensor]:
    """Every tensor of an optimizer state (step counter and moments)."""
    out: List[torch.Tensor] = []
    for field in state:
        if isinstance(field, torch.Tensor):
            out.append(field)
        elif field is not None:
            out.extend(field)
    return out


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
