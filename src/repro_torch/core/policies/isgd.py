"""I-SGD baseline: isolated local SGD — no collaboration, zero targets."""
from __future__ import annotations

import torch

from repro_torch.core import graph as graph_mod
from repro_torch.core.policies.base import ServerPolicy, register_policy


@register_policy("isgd")
class ISGDPolicy(ServerPolicy):
    """Empty graph. The engine never communicates (``uses_reference`` is
    False); a direct ``server_round`` still yields all-zero targets, from
    (N, 0) neighbor lists that launch nothing."""

    uses_reference = False

    def build_graph(self, state, quality: torch.Tensor):
        n = state.active.shape[0]
        dev = state.active.device
        return graph_mod.CollaborationGraph(
            neighbors=torch.zeros((n, 0), dtype=torch.int32, device=dev),
            weights=torch.zeros_like(state.weights), similarity=state.sim,
            candidates=state.active,
            slot_weights=torch.zeros((n, 0), dtype=torch.float32,
                                     device=dev))

    def receivers(self, state, graph) -> torch.Tensor:
        """No collaboration, no downlink: zero wire bytes charged."""
        return torch.zeros_like(state.active)
