"""Client-side state and the stacked cohort step (Algorithm 1 line 12).

Clients of one architecture form a *cohort*: one module (a ``CohortMLP``
or a zoo family's ``StackedCohort``) whose params stack the clients on a
leading axis, trained by the family's own optimizer. A step runs one
forward for the whole cohort and one backward of the summed per-client
losses — clients share no parameter and no norm or attention spans the
client axis, so each gets exactly its own gradient (the counterpart of
the reference's ``vmap(value_and_grad)``). Params are updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import numpy as np
import torch
from torch import nn

from repro_torch.core import wire
from repro_torch.core.distill import sqmd_loss
from repro_torch.core.messenger import cohort_messengers
from repro_torch.optim import Optimizer


@dataclasses.dataclass
class Cohort:
    """All clients sharing one model family."""
    family_name: str
    model: nn.Module                     # stacked (n_c, ...) params
    opt_state: Any                       # stacked, per-client step
    client_ids: np.ndarray               # (n_c,) global client indices
    data: Dict[str, torch.Tensor]        # {x (n_c,M,L), y (n_c,M)}
    optimizer: Optimizer                 # the family's optimizer


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _gate(on: torch.Tensor, old, new):
    """``new`` on the rows of ``on``, ``old`` elsewhere, for a tensor, a
    list of tensors, or None."""
    if new is None:
        return None
    if isinstance(new, torch.Tensor):
        return torch.where(_rows(on, new), new, old)
    return [_gate(on, a, b) for a, b in zip(old, new)]


def cohort_step(model: nn.Module, optimizer: Optimizer,
                opt_state, batch_x: torch.Tensor,
                batch_y: torch.Tensor, ref_x: torch.Tensor,
                targets: torch.Tensor, trainable: torch.Tensor,
                rho: float, use_ref: bool):
    """One optimizer step for a whole cohort, in place on ``model``.

    batch_x (n_c,B,L), batch_y (n_c,B), targets (n_c,R,C) per-client
    distill targets, trainable (n_c,) bool. Rows outside ``trainable``
    keep their params AND every optimizer-state leaf, the per-client step
    counter included, bit for bit. Returns (opt_state, per-client loss)."""
    params = list(model.parameters())
    with torch.enable_grad():
        loss = sqmd_loss(model, batch_x, batch_y, ref_x, targets, rho,
                         use_ref)
        grads = torch.autograd.grad(loss.sum(), params)
    with torch.no_grad():
        updates, new_state = optimizer.update(grads, opt_state,
                                              [p.detach() for p in params])
        on = trainable.to(torch.bool)
        for p, u in zip(params, updates):
            p.copy_(torch.where(_rows(on, p), p + u.to(p.dtype), p))
    # every leaf of the state is gated, the step counter included: a
    # woken client resumes with its own Adam bias correction
    state = type(new_state)(*(_gate(on, a, b)
                              for a, b in zip(opt_state, new_state)))
    return state, loss.detach()


def cohort_messenger_upload(model: nn.Module, ref_x: torch.Tensor,
                            codec: Union[None, str, wire.Codec] = None):
    """(n_c, R, C) log-prob messengers, wire-encoded when ``codec`` is
    given."""
    return cohort_messengers(model, ref_x, codec=codec)


@torch.no_grad()
def cohort_accuracy(model: nn.Module, xs: torch.Tensor,
                    ys: torch.Tensor) -> torch.Tensor:
    """Per-client accuracy on stacked eval shards (n_c, M, L)/(n_c, M)."""
    pred = torch.argmax(model(xs), dim=-1)
    return (pred == ys).float().mean(dim=-1)


@torch.no_grad()
def cohort_accuracy_masked(model: nn.Module, xs: torch.Tensor,
                           ys: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Per-client accuracy over unequal shard lengths: shards padded to
    the cohort max, ``mask (n_c, M)`` marking the real samples."""
    hit = (torch.argmax(model(xs), dim=-1) == ys) & mask
    return hit.sum(dim=-1) / torch.clamp(mask.sum(dim=-1), min=1).float()


@torch.no_grad()
def cohort_pred(model: nn.Module, xs: torch.Tensor) -> torch.Tensor:
    return torch.argmax(model(xs), dim=-1)
