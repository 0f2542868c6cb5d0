"""The ``ServerPolicy`` strategy interface + registry.

A policy is the server-side collaboration strategy of Algorithm 1 lines
7-10, in three stages:

  grade(state, ref_labels)        -> (N,) quality scores       (Eq. 1)
  build_graph(state, quality)     -> CollaborationGraph        (Defs. 4-5)
  emit_targets(state, graph)      -> (N,R,C) distill targets   (Eq. 5)

Every tensor stays on the device the server state lives on; the kernels
dispatch by that device.
"""
from __future__ import annotations

import abc
from typing import Dict, Tuple, Type, Union

import torch

from repro_torch.core import quality as quality_mod
from repro_torch.kernels import ops

_REGISTRY: Dict[str, Type["ServerPolicy"]] = {}


def register_policy(name: str):
    """Class decorator binding ``cls.name`` and making the policy
    reachable by name (Protocol, engine, CLI)."""

    def deco(cls: Type["ServerPolicy"]) -> Type["ServerPolicy"]:
        if name in _REGISTRY:
            raise ValueError(f"policy {name!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def registered_policies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def is_registered(name: str) -> bool:
    return name in _REGISTRY


def get_policy(name: str) -> Type["ServerPolicy"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; registered: "
                       f"{registered_policies()}") from None


def as_policy(policy: Union[str, "ServerPolicy", "Protocol"]  # noqa: F821
              ) -> "ServerPolicy":
    """Coerce a policy instance / Protocol config / name into a policy."""
    if isinstance(policy, ServerPolicy):
        return policy
    if isinstance(policy, str):
        return get_policy(policy)()
    return get_policy(policy.name)(policy)


class ServerPolicy(abc.ABC):
    """Base strategy: subclasses override ``build_graph``."""

    name: str = "?"                 # bound by @register_policy
    # Neighbor-selection strategy, attached by the ServerBus: "exact"
    # keeps the dense (N,N) divergence path; "ivf" lets a policy that
    # supports it (SQMD) run its delta rounds on the approximate
    # NeighborIndex. Policies without an approximate path never read it.
    selection = "exact"

    def __init__(self, protocol=None):
        if protocol is None:
            from repro_torch.core.protocols import Protocol
            protocol = Protocol(self.name)
        self.protocol = protocol

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.protocol})"

    @property
    def rho(self) -> float:
        return self.protocol.rho

    def grade(self, state, ref_labels: torch.Tensor) -> torch.Tensor:
        """(N,) Eq. 1 quality grades of the repository messengers."""
        return quality_mod.quality_scores(state.repo_logp, ref_labels)

    @abc.abstractmethod
    def build_graph(self, state, quality: torch.Tensor):
        """CollaborationGraph for this round."""

    def build_graph_delta(self, state, quality: torch.Tensor, uploaded):
        """Incremental variant: ``uploaded`` is the (N,) bool mask of every
        repository row changed since the last policy round. The default
        ignores it and rebuilds — always correct."""
        return self.build_graph(state, quality)

    def emit_targets(self, state, graph) -> torch.Tensor:
        """(N,R,C) fp32 probability targets: the K^n neighbor mean, gathered
        over the neighbor lists when the graph carries its slot weights,
        else the product with the dense W."""
        probs = torch.exp(state.repo_logp)
        if graph.slot_weights is not None:
            return ops.neighbor_gather(graph.neighbors, graph.slot_weights,
                                       probs)
        return ops.neighbor_mean(graph.weights, probs)

    def receivers(self, state, graph) -> torch.Tensor:
        """(N,) bool — clients a K^n downlink payload is sent to: every
        participating client."""
        return state.active

    def update_state(self, state, quality: torch.Tensor, graph):
        """Fold this round's quality, graph and divergence into the state."""
        div = (graph.divergence if graph.divergence is not None
               else state.div_cache)
        return state._replace(quality=quality, sim=graph.similarity,
                              weights=graph.weights, div_cache=div,
                              round=state.round + 1)
