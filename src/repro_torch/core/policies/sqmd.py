"""SQMD — the paper's protocol: quality top-Q filter, then similarity
top-K neighbors on the dynamic directed graph (Defs. 3-5, Algorithm 1).
Full rebuilds, delta rounds on the cached divergence matrix, and delta
rounds on the approximate IVF index (``selection == "ivf"``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import graph as graph_mod
from repro_torch.core import quality as quality_mod
from repro_torch.core import similarity as sim_mod
from repro_torch.core.policies.base import ServerPolicy, register_policy


@register_policy("sqmd")
class SQMDPolicy(ServerPolicy):
    """Top-Q candidate pool by grade, top-K most-similar neighbors each."""

    computes_similarity = True

    def __init__(self, protocol=None):
        super().__init__(protocol)
        self._ivf: Optional[sim_mod.NeighborIndex] = None  # built lazily

    def build_graph(self, state, quality: torch.Tensor):
        # self.mesh (bus-attached) splits the O(N²·R·C) rebuild into row
        # strips over the client mesh; None is the one-device rebuild
        return self._select(state, quality, sim_mod.divergence_matrix(
            state.repo_logp, mesh=self.mesh))

    def build_graph_delta(self, state, quality: torch.Tensor, uploaded):
        """O(u·N·R·C) round: scatter the uploaded rows' divergence strips
        into the cached matrix instead of rebuilding all N^2 pairs — or,
        under ``selection == "ivf"``, skip the (N,N) matrix entirely and
        maintain the NeighborIndex."""
        if self.selection == "ivf":
            return self._build_graph_ivf(state, quality, uploaded)
        div = sim_mod.update_divergence_cache(state.div_cache,
                                              state.repo_logp, uploaded)
        return self._select(state, quality, div)

    def _select(self, state, quality: torch.Tensor, div: torch.Tensor):
        cand = quality_mod.candidate_mask(quality, state.active,
                                          self.protocol.q)
        return graph_mod.select_neighbors_from_div(div, cand,
                                                   self.protocol.k)

    # -- approximate (IVF) path -------------------------------------------
    def _index_for(self, state) -> sim_mod.NeighborIndex:
        n, r, c = state.repo_logp.shape
        if self._ivf is None or self._ivf.capacity != n:
            self._ivf = sim_mod.NeighborIndex(
                n, r, c, k=self.protocol.k, device=state.repo_logp.device)
        return self._ivf

    def _build_graph_ivf(self, state, quality: torch.Tensor, uploaded):
        """Sub-quadratic round: keep per-client top-L neighbor lists in
        the IVF index and emit a graph whose similarity matrix is nonzero
        only at realized edges. ``graph.divergence`` stays None, so the
        dense div_cache is neither touched nor trusted."""
        idx = self._index_for(state)
        dev = state.repo_logp.device
        up = torch.as_tensor(sim_mod.bool_mask(uploaded), device=dev)
        active = state.active
        # the first fire also ingests rows that joined before the index
        # existed; re-uploads refresh their wire form and lists
        rows = torch.nonzero((up | ~idx.active_rows()) & active).flatten()
        if rows.numel():
            idx.update(rows, state.repo_logp[rows])
        idx.sync_active(active)
        cand = quality_mod.candidate_mask(quality, active, self.protocol.q)
        n = active.shape[0]
        k = max(1, min(self.protocol.k, n - 1))
        nbrs, ndiv = idx.select(cand, k)
        valid = nbrs >= 0
        count = valid.sum(dim=1, keepdim=True)
        safe = torch.where(valid, nbrs, 0).long()
        rows_ix = torch.arange(n, device=dev).repeat_interleave(k)
        cols = safe.reshape(-1)
        vals = torch.where(valid, 1.0 / torch.clamp(count, min=1).float(),
                           0.0)
        sim_vals = torch.where(valid,
                               1.0 / torch.clamp(ndiv, min=sim_mod.EPS), 0.0)
        # add, don't assign: invalid slots clamp to column 0 and must not
        # clobber a realized (i, 0) edge — they contribute exactly 0
        w = torch.zeros((n, n), dtype=torch.float32, device=dev)
        w.index_put_((rows_ix, cols), vals.reshape(-1).float(),
                     accumulate=True)
        sim = torch.zeros((n, n), dtype=torch.float32, device=dev)
        sim.index_put_((rows_ix, cols), sim_vals.reshape(-1).float(),
                       accumulate=True)
        return graph_mod.CollaborationGraph(
            neighbors=safe.int(), weights=w, similarity=sim,
            candidates=cand, slot_weights=vals)
