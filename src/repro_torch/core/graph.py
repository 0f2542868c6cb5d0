"""The dynamic directed collaboration graph (paper Def. 5), and the
baselines' graphs.

Each round the server re-derives every client's neighbor set K^n — the K
most-similar members of the quality pool Q, never the client itself —
with the weight of each neighbor slot (1/K on chosen edges), which the
``neighbor_gather`` kernel consumes, and the row-stochastic selection
matrix W those slots scatter to. FedMD's complete graph carries only its
dense W (the ``neighbor_mean`` entry); D-Dist's static graph carries its
lists like SQMD's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import trace
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


def candidate_pool(candidates: torch.Tensor, k: int):
    """The candidate columns, padded with unrealizable slots (client 0)
    up to k columns: (pool (B,) indices, valid (B,) bool), or None for an
    empty pool. The pool's size depends on the mask's values, so it is
    staged here, apart from the selection over it."""
    with trace.sync("server.pool"):
        pool = torch.nonzero(candidates).flatten()
    if pool.numel() == 0 or k == 0:
        return None
    size = pool.numel()
    pad = max(k - size, 0)
    valid = torch.ones(size + pad, dtype=torch.bool, device=pool.device)
    if pad:
        pool = torch.cat([pool, pool.new_zeros(pad)])
        valid[size:] = False
    return pool, valid


def select_from_pool(similarity: torch.Tensor, pool: torch.Tensor,
                     valid: torch.Tensor, k: int):
    """Top-k over the pool's columns (``candidate_pool``), the invalid
    slots scored -BIG, so a pool smaller than k still yields k slots,
    ordered as the reference's padded pool orders them."""
    n = similarity.shape[0]
    sub = similarity[:, pool]
    rows = torch.arange(n, device=pool.device)[:, None]
    ok = valid[None, :] & (pool[None, :] != rows)       # no self-edges
    sub = torch.where(ok, sub, torch.full_like(sub, -BIG))
    return _topk_weights(sub, pool, k)


def _select_pool(similarity: torch.Tensor, candidates: torch.Tensor,
                 k: int):
    """Top-k over the candidate columns only, or None for an empty
    pool."""
    staged = candidate_pool(candidates, k)
    if staged is None:
        return None
    return select_from_pool(similarity, *staged, k)


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


def fedmd_graph(active: torch.Tensor) -> CollaborationGraph:
    """FedMD: everyone averages everyone (Q = K = N), a complete graph
    over the active clients with uniform weights, self-edges included.
    No slot weights: its targets take the dense entry."""
    n = active.shape[0]
    a = active.float()
    w = (a / torch.clamp(a.sum(), min=1.0))[None, :].expand(n, n)
    w = w.contiguous()
    nbrs = torch.arange(n, dtype=torch.int32,
                        device=active.device)[None, :].expand(n, n)
    return CollaborationGraph(neighbors=nbrs, weights=w, similarity=w,
                              candidates=active)


def ddist_graph(generator: torch.Generator, n: int, k: int,
                active: Optional[torch.Tensor] = None
                ) -> CollaborationGraph:
    """D-Dist: a static random K-neighbor graph, drawn once at setup; no
    server-side filtering.

    Each row samples uniformly without replacement over the active,
    non-self clients: Gumbel scores (from ``generator``, on its device)
    plus log p, the first k of a stable descending sort; slots scored
    -inf are unrealizable and carry weight 0. k is clamped to n - 1, rows
    renormalize over their realized edges, and an all-inactive federation
    yields an all-zero (NaN-free) W."""
    dev = generator.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    active = active.to(dev)
    k = min(k, n - 1)
    u = torch.rand((n, n), generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(torch.clamp(
        u, min=torch.finfo(torch.float32).tiny)))
    p = active.float()[None, :].expand(n, n).clone()
    p.fill_diagonal_(0.0)
    order = torch.sort(gumbel + torch.log(p), dim=1, descending=True,
                       stable=True)
    nbrs = order.indices[:, :k].to(torch.int32)
    valid = torch.isfinite(order.values[:, :k]).float()
    vals = valid / torch.clamp(valid.sum(dim=1, keepdim=True), min=1.0)
    w = torch.zeros((n, n), dtype=torch.float32, device=dev)
    w.index_put_((torch.arange(n, device=dev).repeat_interleave(k),
                  nbrs.reshape(-1).long()), vals.reshape(-1),
                 accumulate=True)
    return CollaborationGraph(
        neighbors=nbrs, weights=w,
        similarity=torch.zeros((n, n), dtype=torch.float32, device=dev),
        candidates=active, slot_weights=vals)


def _mean_as_jnp(total: int, count: int) -> float:
    """The mean of ``count`` integers summing to ``total`` as the
    reference's ``jnp.mean`` reads it: the fp32 sum times the fp32
    reciprocal of the count (XLA turns the division by a constant into
    that product), e.g. 6.000000476837158 for 28 rows of 6. On the host,
    so the card and the CPU read the same bits (torch.mean read 6.0 on
    the CPU and 6.000000476837158 on the card)."""
    return float(np.float32(total) * (np.float32(1) / np.float32(count)))


def graph_stats(g: CollaborationGraph) -> dict:
    """Diagnostics: degree distribution and reciprocity of the edges."""
    adj = g.weights > 0
    in_deg = adj.sum(dim=0)
    recip = (adj & adj.T).sum() / torch.clamp(adj.sum(), min=1)
    return {
        "out_degree": _mean_as_jnp(int(adj.sum()), adj.shape[0]),
        "in_degree_max": int(in_deg.max()),
        "in_degree_min": int(in_deg.min()),
        "reciprocity": float(recip),
        "n_candidates": int(g.candidates.sum()),
    }
