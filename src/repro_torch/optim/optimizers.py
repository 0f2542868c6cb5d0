"""SGD with momentum over a cohort's stacked params.

The reference's (init, update) contract, written for stacked tensors:
``update`` maps (grads, state) -> (updates, state) and the caller adds
the updates. The step counter is per client (``(n_c,)`` int32), moments
are fp32 whatever the param dtype. ``momentum=0`` is plain SGD.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Sequence

import torch


class SGDState(NamedTuple):
    step: torch.Tensor               # (n_c,) int32
    momentum: List[torch.Tensor]     # one fp32 tensor per param


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Sequence[torch.Tensor]], SGDState]
    update: Callable[[Sequence[torch.Tensor], SGDState], tuple]


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        return SGDState(
            step=torch.zeros((params[0].shape[0],), dtype=torch.int32,
                             device=params[0].device),
            momentum=[torch.zeros_like(p, dtype=torch.float32)
                      for p in params])

    def update(grads, state):
        mom = [momentum * m + g.float()
               for m, g in zip(state.momentum, grads)]
        return [-lr * m for m in mom], SGDState(state.step + 1, mom)

    return Optimizer(init, update)
