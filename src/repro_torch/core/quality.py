"""Model quality (paper Def. 3, Eq. 1) and the top-Q candidate filter.

Each client's grade is the summed cross-entropy of its messenger against
the server's reference labels; the Q lowest-loss ACTIVE clients form the
candidate pool. Every client still receives K neighbors.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.kernels import ops

BIG = 1e30


def quality_scores(messengers_logp: torch.Tensor,
                   ref_labels: torch.Tensor) -> torch.Tensor:
    """g (N,) — Eq. 1 summed CE of each messenger vs the server's labels
    (on log-probs logsumexp is 0, so CE = -logp[y])."""
    return ops.soft_ce(messengers_logp, ref_labels)


def candidate_mask(quality: torch.Tensor, active: torch.Tensor,
                   q: int) -> torch.Tensor:
    """Boolean (N,) mask of the Q lowest-loss active clients.

    Inactive clients score BIG and never enter Q. Ties go to the lower
    client index, as ``jax.lax.top_k`` breaks them: a stable ascending
    sort keeps index order among equal scores."""
    scores = torch.where(active, quality.float(),
                         torch.full_like(quality, BIG, dtype=torch.float32))
    n = quality.shape[0]
    idx = torch.sort(scores, stable=True).indices[:min(q, n)]
    mask = torch.zeros((n,), dtype=torch.bool, device=quality.device)
    with trace.sync("server.candidates"):     # True is copied from the host
        mask[idx] = True
    return mask & active
