"""One SQMD round, plain (Algorithm 1; Eqs. 1, 2, 5, 6 of the paper).

Client side: each client takes one SGD step with momentum on
``(1 - rho) CE(batch) + rho mean_j ||softmax(f(x_ref_j)) - target_j||^2``
(the second term from the second round on), then uploads the
log-softmax of its reference-set logits. Server side: Eq. 1 grades each
repository row by its summed cross-entropy against the reference
labels, the Q lowest-graded active rows form the pool, Eq. 2 gives the
divergence D[n, m] = mean_j KL(p_n,j || p_m,j), each client takes the K
pool members (never itself) of largest 1/D as neighbours with weight
1/K, and Eq. 5 averages their probabilities into its target; clients
that never uploaded get a zero target.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import operand

EPS = 1e-8          # the floor under D before 1/D
BIG = 1e30          # the grade of a row outside the pool
BLOCK = 2048        # rows of D computed at once


def client_losses(forward, params: Dict[str, torch.Tensor],
                  xb: torch.Tensor, yb: torch.Tensor, ref_x: torch.Tensor,
                  targets: torch.Tensor, rho: float, use_ref: bool,
                  precision: str, half_batch: bool = False) -> torch.Tensor:
    """(n_c,) Eq. 6 losses. ``half_batch`` is a fault: the cross-entropy
    is the mean over the first half of the batch."""
    if half_batch:
        xb, yb = xb[:, :xb.shape[1] // 2], yb[:, :yb.shape[1] // 2]
    logp = F.log_softmax(forward(params, xb, precision), dim=-1)
    ce = -torch.gather(logp, -1, yb[..., None])[..., 0].mean(dim=-1)
    if not use_ref:
        return ce
    ref_in = ref_x.expand((xb.shape[0],) + tuple(ref_x.shape))
    probs = F.softmax(forward(params, ref_in, precision), dim=-1)
    ref = ((probs - targets) ** 2).sum(dim=-1).mean(dim=-1)
    return (1.0 - rho) * ce + rho * ref


def sgd_step(params: Dict[str, torch.Tensor],
             momentum: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], on: torch.Tensor, lr: float,
             beta: float) -> None:
    """In place, only on the clients of ``on``: m <- beta m + g,
    theta <- theta - lr m."""
    for k, g in grads.items():
        rows = on.reshape((-1,) + (1,) * (g.dim() - 1))
        m = beta * momentum[k] + g
        momentum[k] = torch.where(rows, m, momentum[k])
        params[k] = torch.where(rows, params[k] - lr * m, params[k])


@torch.no_grad()
def messengers(forward, params: Dict[str, torch.Tensor],
               ref_x: torch.Tensor, precision: str) -> torch.Tensor:
    """(n_c, R, C) log-probabilities on the reference set."""
    n_c = next(iter(params.values())).shape[0]
    ref_in = ref_x.expand((n_c,) + tuple(ref_x.shape))
    return F.log_softmax(forward(params, ref_in, precision), dim=-1)


def grades(repo: torch.Tensor, ref_y: torch.Tensor) -> torch.Tensor:
    """Eq. 1: g[n] = sum_j (logsumexp_c S[n,j] - S[n,j,y_j])."""
    lse = torch.logsumexp(repo, dim=-1)
    picked = repo[:, torch.arange(repo.shape[1], device=repo.device),
                  ref_y.long()]
    return (lse - picked).sum(dim=-1)


def divergence(repo: torch.Tensor, precision: str) -> torch.Tensor:
    """Eq. 2, (N, N): rowterm[n] - <p_n, log p_m>, over R."""
    n, r, c = repo.shape
    lp = repo.reshape(n, r * c)
    p = torch.exp(lp)
    rowterm = (p * lp).sum(dim=-1)
    out = torch.empty((n, n), dtype=repo.dtype, device=repo.device)
    lb = operand(lp, precision)
    for i in range(0, n, BLOCK):
        cross = operand(p[i:i + BLOCK], precision) @ lb.T
        out[i:i + BLOCK] = (rowterm[i:i + BLOCK, None] - cross) / r
    return out


def candidates(g: torch.Tensor, active: torch.Tensor, q: int
               ) -> torch.Tensor:
    """The Q lowest grades among active rows (ties to the lower index)."""
    scores = torch.where(active, g, torch.full_like(g, BIG))
    idx = torch.sort(scores, stable=True).indices[:min(q, g.shape[0])]
    mask = torch.zeros_like(active)
    mask[idx] = True
    return mask & active


def n_neighbours(n: int, k: int) -> int:
    return min(k, n - 1)


def select(div: torch.Tensor, cand: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's K pool members of largest 1/D, never itself: (indices
    (N, K) long, slot weights (N, K)), 1/count on realized slots."""
    n = div.shape[0]
    k = n_neighbours(n, k)
    pool = torch.nonzero(cand).flatten()
    nbrs = torch.zeros((n, k), dtype=torch.long, device=div.device)
    slot = torch.zeros((n, k), dtype=div.dtype, device=div.device)
    if pool.numel() == 0 or k == 0:
        return nbrs, slot
    rows = torch.arange(n, device=div.device)
    for i in range(0, n, BLOCK):
        r = rows[i:i + BLOCK]
        sub = similarity_rows(div, r)[:, pool]
        sub = torch.where(pool[None, :] == r[:, None],
                          torch.full_like(sub, -BIG), sub)
        if sub.shape[1] < k:
            sub = torch.cat([sub, torch.full((len(r), k - sub.shape[1]),
                                             -BIG, dtype=sub.dtype,
                                             device=div.device)], 1)
        order = torch.sort(sub, dim=1, descending=True, stable=True)
        top = order.indices[:, :k]
        valid = order.values[:, :k] > -BIG / 2
        padded = torch.cat([pool, pool.new_zeros(k)])
        nbrs[i:i + BLOCK] = padded[top]
        cnt = valid.to(slot.dtype).sum(dim=1, keepdim=True)
        slot[i:i + BLOCK] = valid.to(slot.dtype) / torch.clamp(cnt, min=1.0)
    return nbrs, slot


def similarity_rows(div: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Rows of 1/D with a zero diagonal."""
    s = 1.0 / torch.clamp(div[rows], min=EPS)
    s[torch.arange(len(rows), device=div.device), rows] = 0.0
    return s


def targets(repo: torch.Tensor, nbrs: torch.Tensor, slot: torch.Tensor,
            active: torch.Tensor) -> torch.Tensor:
    """Eq. 5: the slot-weighted mean of the neighbours' probabilities;
    zero for clients that never uploaded (nothing is sent to them)."""
    n = repo.shape[0]
    out = torch.empty_like(repo)
    for i in range(0, n, BLOCK):
        p = torch.exp(repo[nbrs[i:i + BLOCK]])              # (b, K, R, C)
        out[i:i + BLOCK] = (slot[i:i + BLOCK, :, None, None] * p).sum(1)
    return torch.where(active[:, None, None], out, torch.zeros_like(out))
