"""Client-side state and the stacked cohort step (Algorithm 1 line 12).

Clients of one architecture form a *cohort*: one ``CohortMLP`` whose
params stack the clients on a leading axis. A step runs one forward for
the whole cohort and one backward of the summed per-client losses —
clients share no parameter, so each gets exactly its own gradient (the
counterpart of the reference's ``vmap(value_and_grad)``). Params are
updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch

from repro_torch.core import wire
from repro_torch.core.distill import sqmd_loss
from repro_torch.core.messenger import cohort_messengers
from repro_torch.models.mlp import CohortMLP
from repro_torch.optim import Optimizer, SGDState


@dataclasses.dataclass
class Cohort:
    """All clients sharing one model family."""
    family_name: str
    model: CohortMLP                     # stacked (n_c, ...) params
    opt_state: SGDState                  # stacked, per-client step
    client_ids: np.ndarray               # (n_c,) global client indices
    data: Dict[str, torch.Tensor]        # {x (n_c,M,L), y (n_c,M)}


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def cohort_step(model: CohortMLP, optimizer: Optimizer,
                opt_state: SGDState, batch_x: torch.Tensor,
                batch_y: torch.Tensor, ref_x: torch.Tensor,
                targets: torch.Tensor, trainable: torch.Tensor,
                rho: float, use_ref: bool):
    """One SGD step for a whole cohort, in place on ``model``.

    batch_x (n_c,B,L), batch_y (n_c,B), targets (n_c,R,C) per-client
    distill targets, trainable (n_c,) bool. Rows outside ``trainable``
    keep their params AND every optimizer-state leaf, the per-client step
    counter included, bit for bit. Returns (opt_state, per-client loss)."""
    params = list(model.parameters())
    with torch.enable_grad():
        loss = sqmd_loss(model, batch_x, batch_y, ref_x, targets, rho,
                         use_ref)
        grads = torch.autograd.grad(loss.sum(), params)
    updates, new_state = optimizer.update(grads, opt_state)
    on = trainable.to(torch.bool)
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.copy_(torch.where(_rows(on, p), p + u.to(p.dtype), p))
    step = torch.where(on, new_state.step, opt_state.step)
    mom = [torch.where(_rows(on, b), b, a)
           for a, b in zip(opt_state.momentum, new_state.momentum)]
    return SGDState(step, mom), loss.detach()


def cohort_messenger_upload(model: CohortMLP, ref_x: torch.Tensor,
                            codec: Union[None, str, wire.Codec] = None):
    """(n_c, R, C) log-prob messengers, wire-encoded when ``codec`` is
    given."""
    return cohort_messengers(model, ref_x, codec=codec)


@torch.no_grad()
def cohort_accuracy(model: CohortMLP, xs: torch.Tensor,
                    ys: torch.Tensor) -> torch.Tensor:
    """Per-client accuracy on stacked eval shards (n_c, M, L)/(n_c, M)."""
    pred = torch.argmax(model(xs), dim=-1)
    return (pred == ys).float().mean(dim=-1)


@torch.no_grad()
def cohort_accuracy_masked(model: CohortMLP, xs: torch.Tensor,
                           ys: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Per-client accuracy over unequal shard lengths: shards padded to
    the cohort max, ``mask (n_c, M)`` marking the real samples."""
    hit = (torch.argmax(model(xs), dim=-1) == ys) & mask
    return hit.sum(dim=-1) / torch.clamp(mask.sum(dim=-1), min=1).float()


@torch.no_grad()
def cohort_pred(model: CohortMLP, xs: torch.Tensor) -> torch.Tensor:
    return torch.argmax(model(xs), dim=-1)
