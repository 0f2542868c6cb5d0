"""Reading a cohort's leaves out of the port by parameter name."""
from __future__ import annotations

from typing import Callable, Dict

import torch


def host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that later rounds, which update in place, leave be."""
    return t.detach().to("cpu", copy=True)


def export(cohort, rename: Callable[[str], str]) -> Dict[str, Dict[str,
                                                                torch.Tensor]]:
    """{"params": {leaf: tensor}, "momentum": {leaf: tensor}} of the
    cohort's real clients, copied to the host."""
    names = [rename(k) for k, _ in cohort.module.named_parameters()]
    params = cohort.real_params
    state = cohort.real_opt_state
    mom = getattr(state, "momentum", None)
    out = {"params": {rename(k): host(v) for k, v in params.items()}}
    if mom is not None:
        out["momentum"] = {n: host(m) for n, m in zip(names, mom)}
    return out
