"""D-Dist baseline (Bistritz et al. 2020): a static random K-neighbor
graph drawn once at setup; no server-side quality or similarity
filtering.

The static graph is kept as its (N, K) neighbor lists and their slot
weights (each row's nonzeros in ascending column order), so a round's
targets go through the gather (``ops.neighbor_gather``), K products a
row instead of the dense product's N."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.convert import static_weights_from_numpy
from repro_torch.core import graph as graph_mod
from repro_torch.core.policies.base import ServerPolicy, register_policy


@register_policy("ddist")
class DDistPolicy(ServerPolicy):
    """Static graph, re-masked each round so never-joined clients carry no
    weight (their rows renormalize over the realized edges)."""

    def __init__(self, protocol=None, static_weights=None):
        super().__init__(protocol)
        self.static_weights: Optional[torch.Tensor] = None  # dense (N, N)
        self.neighbors: Optional[torch.Tensor] = None     # (N, K) int32
        self.slot_weights: Optional[torch.Tensor] = None  # (N, K) fp32
        if static_weights is not None:
            self.attach_static_weights(static_weights)

    def setup(self, generator: torch.Generator, n_clients: int) -> None:
        if self.static_weights is None:
            self.attach_static_weights(graph_mod.ddist_graph(
                generator, n_clients, self.protocol.k).weights)

    def attach_static_weights(self, weights) -> None:
        """A dense (N, N) static graph (numpy or tensor, kept on its
        device) -> each row's nonzeros in ascending column order as its
        lists, padded with weight-0 slots to the widest row."""
        w = (static_weights_from_numpy(weights, "cpu")
             if isinstance(weights, np.ndarray) else weights.float())
        self.static_weights = w
        n = w.shape[0]
        nz = w != 0
        k = int(nz.sum(dim=1).max()) if n else 0
        # a stable sort puts each row's nonzero columns first, ascending
        cols = torch.sort((~nz).to(torch.int8), dim=1, stable=True).indices
        cols = cols[:, :k]
        self.neighbors = cols.to(torch.int32)
        self.slot_weights = torch.gather(w, 1, cols)

    def build_graph(self, state, quality: torch.Tensor):
        if self.static_weights is None:
            raise ValueError("ddist needs its static graph: call "
                             "policy.setup(generator, n) or pass "
                             "static_weights")
        dev = state.active.device
        if self.neighbors.device != dev:
            self.static_weights = self.static_weights.to(dev)
            self.neighbors = self.neighbors.to(dev)
            self.slot_weights = self.slot_weights.to(dev)
        nbrs = self.neighbors
        slots = self.slot_weights * state.active[nbrs.long()].float()
        slots = slots / torch.clamp(slots.sum(dim=1, keepdim=True),
                                    min=1e-9)
        n, k = nbrs.shape
        w = torch.zeros((n, n), dtype=torch.float32, device=dev)
        # padded slots carry weight 0: they add nothing
        w.index_put_((torch.arange(n, device=dev).repeat_interleave(k),
                      nbrs.reshape(-1).long()), slots.reshape(-1),
                     accumulate=True)
        return graph_mod.CollaborationGraph(
            neighbors=nbrs, weights=w, similarity=state.sim,
            candidates=state.active, slot_weights=slots)

    def receivers(self, state, graph) -> torch.Tensor:
        """A client whose static edges all point at never-joined peers
        gets an all-zero row — the server skips its downlink payload."""
        return state.active & (graph.slot_weights.sum(dim=1) > 0)
