"""The SQMD central server (Algorithm 1 lines 5–10).

State (tensors on the server's device):
  repo_logp (N,R,C)  messenger repository S (stale rows allowed: asynchrony)
  active    (N,)     participation mask (clients that have ever joined)
  quality   (N,)     latest Eq. 1 grades
  sim       (N,N)    latest similarity matrix C (Def. 5)
  weights   (N,N)    current collaboration-graph selection matrix W
  round     ()       round counter
  div_cache (N,N)    Eq. 2 divergence matrix of the current repository
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import Device, resolve_device, trace
from repro_torch.core import quality as quality_mod
from repro_torch.core import wire


class ServerState(NamedTuple):
    repo_logp: torch.Tensor
    active: torch.Tensor
    quality: torch.Tensor
    sim: torch.Tensor
    weights: torch.Tensor
    round: torch.Tensor
    div_cache: torch.Tensor


def init_server(n_clients: int, ref_size: int, n_classes: int,
                device: Device = None) -> ServerState:
    """Repository starts uniform (max-entropy messengers => worst quality,
    so un-joined clients are naturally excluded from Q). ``device=None``
    is the card."""
    dev = resolve_device(device)
    # -log(C) rounded to fp32 once, as the reference's jnp.log does
    uniform = torch.full((n_clients, ref_size, n_classes),
                         float(np.float32(-math.log(n_classes))),
                         dtype=torch.float32, device=dev)
    return ServerState(
        repo_logp=uniform,
        active=torch.zeros((n_clients,), dtype=torch.bool, device=dev),
        quality=torch.full((n_clients,), quality_mod.BIG,
                           dtype=torch.float32, device=dev),
        sim=torch.zeros((n_clients, n_clients), dtype=torch.float32,
                        device=dev),
        weights=torch.zeros((n_clients, n_clients), dtype=torch.float32,
                            device=dev),
        round=torch.zeros((), dtype=torch.int32, device=dev),
        # KL(p||p) = 0 everywhere on the uniform repository
        div_cache=torch.zeros((n_clients, n_clients), dtype=torch.float32,
                              device=dev),
    )


def upload_messengers(state: ServerState,
                      messengers_logp: Union[torch.Tensor, wire.Payload],
                      uploaded: torch.Tensor) -> ServerState:
    """Merge fresh messengers into the repository (rows where uploaded).

    A ``wire.Payload`` is decoded on ingest, only the uploading rows of
    it. Clients that skipped this round keep their STALE row — the
    paper's asynchronous semantics."""
    dev = state.repo_logp.device
    with trace.sync("upload.mask"):
        up = torch.as_tensor(uploaded, dtype=torch.bool).to(dev)
    if isinstance(messengers_logp, wire.Payload):
        with trace.sync("upload.rows"):
            rows = torch.nonzero(up).flatten()
        active = state.active | up
        if rows.numel() == 0:
            return state._replace(active=active)
        dec = wire.decode(wire.gather(messengers_logp, rows))
        repo = state.repo_logp.clone()
        repo[rows] = dec.float()
        return state._replace(repo_logp=repo, active=active)
    repo = torch.where(up[:, None, None], messengers_logp.float(),
                       state.repo_logp)
    return state._replace(repo_logp=repo, active=state.active | up)


STALENESS_BINS: Tuple[float, ...] = (0.0, 1.0, 2.0, 4.0, 8.0)


def staleness_summary(last_upload_t: np.ndarray, active: np.ndarray,
                      now: float,
                      bins: Sequence[float] = STALENESS_BINS) -> dict:
    """Histogram of repository-row staleness (age of each row's newest
    merged messenger) at virtual time ``now``; never-uploaded rows are
    excluded. Plain-python values."""
    last = np.asarray(last_upload_t, float)
    ages = now - last[np.asarray(active, bool) & np.isfinite(last)]
    edges = list(bins) + [np.inf]
    if ages.size == 0:
        return {"n": 0, "mean": 0.0, "max": 0.0, "n_stale": 0,
                "hist": [0] * (len(edges) - 1), "bin_edges": list(bins)}
    hist, _ = np.histogram(ages, bins=edges)
    return {"n": int(ages.size), "mean": float(ages.mean()),
            "max": float(ages.max()), "n_stale": int((ages > 1e-9).sum()),
            "hist": [int(h) for h in hist], "bin_edges": list(bins)}


def policy_round(state: ServerState, policy, ref_labels: torch.Tensor,
                 uploaded: Optional[np.ndarray] = None):
    """Lines 7–10: grade -> build graph -> emit targets.

    ``policy`` is a resolved ServerPolicy. ``uploaded``, when given, is
    the boolean (N,) mask of every repository row changed since the last
    policy round: the policy may then take its incremental graph update
    (``build_graph_delta``); ``None`` always rebuilds. Returns (new_state,
    targets (N,R,C) fp32, CollaborationGraph)."""
    with trace.span("server.grade"):
        g = policy.grade(state, ref_labels)
    with trace.span("server.graph"):
        if uploaded is None:
            graph = policy.build_graph(state, g)
        else:
            graph = policy.build_graph_delta(state, g, uploaded)
    with trace.span("server.targets"):
        targets = policy.emit_targets(state, graph)
    return policy.update_state(state, g, graph), targets, graph


def server_round(state: ServerState, protocol, ref_labels: torch.Tensor,
                 static_weights=None) -> Tuple[ServerState, torch.Tensor]:
    """One server round under a Protocol, policy instance or name.
    Returns (new_state, targets (N,R,C) fp32). For "ddist" pass the
    static graph's dense ``static_weights`` (or a policy after
    ``setup``)."""
    from repro_torch.core.policies import as_policy
    pol = as_policy(protocol, static_weights=static_weights)
    new, targets, _ = policy_round(state, pol, ref_labels)
    return new, targets
