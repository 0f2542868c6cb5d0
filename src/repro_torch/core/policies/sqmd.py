"""SQMD — the paper's protocol: quality top-Q filter, then similarity
top-K neighbors on the dynamic directed graph (Defs. 3-5, Algorithm 1).
This slice ports the exact full-rebuild branch."""
from __future__ import annotations

import torch

from repro_torch.core import graph as graph_mod
from repro_torch.core import quality as quality_mod
from repro_torch.core import similarity as sim_mod
from repro_torch.core.policies.base import ServerPolicy, register_policy


@register_policy("sqmd")
class SQMDPolicy(ServerPolicy):
    """Top-Q candidate pool by grade, top-K most-similar neighbors each."""

    def build_graph(self, state, quality: torch.Tensor):
        div = sim_mod.divergence_matrix(state.repo_logp)
        cand = quality_mod.candidate_mask(quality, state.active,
                                          self.protocol.q)
        return graph_mod.select_neighbors_from_div(div, cand,
                                                   self.protocol.k)
