"""FedMD baseline (Li & Wang 2019): everyone distills toward the global
average messenger — the Q = K = N degenerate case of SQMD."""
from __future__ import annotations

import torch

from repro_torch.core import graph as graph_mod
from repro_torch.core.policies.base import ServerPolicy, register_policy


@register_policy("fedmd")
class FedMDPolicy(ServerPolicy):
    """Complete graph over the active clients, uniform weights. Its graph
    carries no slot weights, so its targets are the dense product W S
    (``ops.neighbor_mean``)."""

    def build_graph(self, state, quality: torch.Tensor):
        # O(N) a round already: the base build_graph_delta (ignore the
        # uploaded mask, rebuild) is FedMD's delta path
        return graph_mod.fedmd_graph(state.active)
