"""The dynamic directed collaboration graph (paper Def. 5).

Each round the server re-derives every client's neighbor set K^n — the K
most-similar members of the quality pool Q, never the client itself —
with the weight of each neighbor slot (1/K on chosen edges), which the
``neighbor_gather`` kernel consumes, and the row-stochastic selection
matrix W those slots scatter to.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.quality import BIG
from repro_torch.core.similarity import similarity_matrix


class CollaborationGraph(NamedTuple):
    neighbors: torch.Tensor      # (N, K) int32 neighbor indices
    weights: torch.Tensor        # (N, N) fp32 row-stochastic selection matrix
    similarity: torch.Tensor     # (N, N) fp32 c_nm (the C matrix of Def. 5)
    candidates: torch.Tensor     # (N,) bool — the Q pool
    divergence: Optional[torch.Tensor] = None  # (N,N) Eq. 2 matrix it was
    # built from, when the policy computed one
    slot_weights: Optional[torch.Tensor] = None  # (N, K) fp32 weight of
    # each neighbor slot, 0 on unrealized ones: W's nonzeros, by slot


def _topk_weights(sub: torch.Tensor, pool: torch.Tensor, k: int):
    """(N,B) masked pool scores -> ((N,K) neighbors, (N,N) weights, (N,K)
    slot weights).

    A stable descending sort takes the first k, so equal scores go to the
    lower pool position (= lower client index), as ``jax.lax.top_k``
    does; ``torch.topk`` promises no such order."""
    n = sub.shape[0]
    order = torch.sort(sub, dim=1, descending=True, stable=True)
    top_vals, top_sub = order.values[:, :k], order.indices[:, :k]
    nbrs = pool[top_sub].to(torch.int32)
    valid = top_vals > -BIG / 2                             # realized edges
    count = valid.float().sum(dim=1, keepdim=True)
    vals = valid.float() / torch.clamp(count, min=1.0)
    w = torch.zeros((n, n), dtype=torch.float32, device=sub.device)
    rows = torch.arange(n, device=sub.device).repeat_interleave(k)
    # duplicates only come from unrealized slots, which add exactly 0
    w.index_put_((rows, nbrs.reshape(-1).long()), vals.reshape(-1),
                 accumulate=True)
    return nbrs, w, vals


def _select_pool(similarity: torch.Tensor, candidates: torch.Tensor,
                 k: int):
    """Top-k over the candidate columns only, or None for an empty pool.

    The pool is padded with unrealizable slots (client 0, scored -BIG) up
    to k columns, so a pool smaller than k still yields k slots, ordered
    as the reference's padded pool orders them."""
    pool = torch.nonzero(candidates).flatten()
    if pool.numel() == 0 or k == 0:
        return None
    n = similarity.shape[0]
    size = pool.numel()
    pad = max(k - size, 0)
    valid = torch.ones(size + pad, dtype=torch.bool, device=pool.device)
    if pad:
        pool = torch.cat([pool, pool.new_zeros(pad)])
        valid[size:] = False
    sub = similarity[:, pool]
    rows = torch.arange(n, device=pool.device)[:, None]
    ok = valid[None, :] & (pool[None, :] != rows)       # no self-edges
    sub = torch.where(ok, sub, torch.full_like(sub, -BIG))
    return _topk_weights(sub, pool, k)


def _empty(n: int, k: int, device) -> tuple:
    return (torch.zeros((n, k), dtype=torch.int32, device=device),
            torch.zeros((n, n), dtype=torch.float32, device=device),
            torch.zeros((n, k), dtype=torch.float32, device=device))


def select_neighbors(similarity: torch.Tensor, candidates: torch.Tensor,
                     k: int) -> CollaborationGraph:
    """Top-K most-similar candidates per client (directed edges n -> m).

    Clients outside Q still get K neighbors; a client never selects
    itself; with fewer than K candidates a row renormalizes over its
    realized edges (the other slots carry weight 0 and an arbitrary
    index)."""
    n = similarity.shape[0]
    k = min(k, n - 1)
    sel = _select_pool(similarity, candidates, k)
    nbrs, w, vals = sel if sel is not None else _empty(n, k,
                                                       similarity.device)
    return CollaborationGraph(neighbors=nbrs, weights=w,
                              similarity=similarity, candidates=candidates,
                              slot_weights=vals)


def select_neighbors_from_div(divergence: torch.Tensor,
                              candidates: torch.Tensor,
                              k: int) -> CollaborationGraph:
    """``select_neighbors`` on the Def. 4 similarity of a divergence
    matrix; the graph carries both matrices."""
    g = select_neighbors(similarity_matrix(divergence), candidates, k)
    return g._replace(divergence=divergence)


def graph_stats(g: CollaborationGraph) -> dict:
    """Diagnostics: degree distribution and reciprocity of the edges."""
    adj = g.weights > 0
    in_deg = adj.sum(dim=0)
    recip = (adj & adj.T).sum() / torch.clamp(adj.sum(), min=1)
    return {
        "out_degree": float(adj.sum(dim=1).float().mean()),
        "in_degree_max": int(in_deg.max()),
        "in_degree_min": int(in_deg.min()),
        "reciprocity": float(recip),
        "n_candidates": int(g.candidates.sum()),
    }
