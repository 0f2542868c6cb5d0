"""The SQMD objective (paper Eq. 3/5/6), per client of a stacked cohort.

L*    = (1-ρ)·L_loc + ρ·L_ref
L_loc = mean CE on the private batch                         (Eq. 3)
L_ref = (1/R) Σ_j ‖ φ(θ, x̄_j) − target_j ‖²                 (Eq. 5)

Every function takes cohort logits ``(n_c, ·, C)`` and returns one loss
per client ``(n_c,)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def local_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Eq. 3 — mean cross-entropy; logits (n_c,B,C), y (n_c,B) int."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, y.long()[..., None])[..., 0]
    return -ll.mean(dim=-1)


def ref_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Eq. 5 — mean over R of the squared L2 between the client's soft
    decision and its neighbor-mean target; logits/targets (n_c,R,C)."""
    probs = F.softmax(logits.float(), dim=-1)
    return torch.sum((probs - targets) ** 2, dim=-1).mean(dim=-1)


def sqmd_loss(model, x: torch.Tensor, y: torch.Tensor, ref_x: torch.Tensor,
              targets: torch.Tensor, rho: float,
              use_ref: bool) -> torch.Tensor:
    """Eq. 6 per client. ``ref_x (R, ...)`` is shared by every client;
    ``use_ref=False`` is pure local training."""
    loc = local_loss(model(x), y)
    if not use_ref:
        return loc
    ref_in = ref_x.expand((x.shape[0],) + tuple(ref_x.shape))
    ref = ref_loss(model(ref_in), targets)
    return (1.0 - rho) * loc + rho * ref
