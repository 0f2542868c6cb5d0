"""Versioned snapshots of the federation's personalized params.

Training updates each cohort's stacked params in place every local step,
so serving must never read the live tensors. ``publish`` copies each
cohort's real rows (``Cohort.real_params``: a sharded cohort's ghost rows
sliced off, its shards gathered) onto the federation's device together
with the client -> (cohort, row) routing table, then swaps the store's current snapshot in one attribute
assignment (atomic under the GIL). A snapshot never changes after it is
published, whatever the training does next. The copy is what a publish
costs: ``SnapshotStore`` counts its bytes and host seconds.

Every snapshot records its ``version`` (monotone publish counter) and
``published_at`` (virtual publish time), so each response can report
model staleness: how old the params that answered the query are, in the
virtual-time units the training runtime uses.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CohortView:
    """One cohort's stacked params as copied at publish time.

    ``module`` is the cohort's module, used only for its architecture
    (``torch.func.functional_call`` runs it on ``params``); ``params``
    maps its parameter names to the copies."""
    family_name: str
    module: nn.Module
    params: Params
    client_ids: np.ndarray      # (n_real,) global ids, row i serves them
    n_real: int


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """An immutable, consistent serving view of every client's model."""
    version: int
    published_at: float
    n_clients: int
    views: Tuple[CohortView, ...]
    view_of: np.ndarray          # (N,) cohort-view index per client
    row_of: np.ndarray           # (N,) row inside that view's stack

    def staleness(self, now: float) -> float:
        """Virtual age of this snapshot at query time ``now``."""
        return max(0.0, float(now) - self.published_at)

    def params_for(self, client_id: int) -> Params:
        """The (unstacked) params serving ``client_id``, by name: the
        parity accessor; the serving path gathers from the stack."""
        view = self.views[int(self.view_of[client_id])]
        row = int(self.row_of[client_id])
        return {k: v[row] for k, v in view.params.items()}


class SnapshotStore:
    """Atomically swapped snapshot sequence the engines publish into.

    ``publish`` is wired to the engines' publish hooks
    (``engine.attach_snapshots(store)``): the sync engine publishes after
    every round, the async engine after every wake and every server fire.
    Readers call ``current()`` and keep the returned snapshot for the
    whole request.

    ``publish_bytes`` is the size of the last publish's copies,
    ``publish_s`` the host seconds of all publishes (on the card the
    copies are enqueued, not awaited)."""

    def __init__(self):
        self._current: Optional[Snapshot] = None
        self.n_published = 0
        self.publish_bytes = 0
        self.publish_s = 0.0

    def publish(self, federation, t: float) -> Snapshot:
        """Copy the federation's per-client params as the next snapshot
        version and swap it in."""
        t0 = time.perf_counter()
        views = []
        n = federation.n_clients
        view_of = np.full(n, -1, np.int64)
        row_of = np.full(n, -1, np.int64)
        size = 0
        dev = federation.device
        for vi, coh in enumerate(federation.cohorts):
            ids = np.asarray(coh.client_ids)
            params = {k: p.to(dev, copy=True)
                      for k, p in coh.real_params.items()}
            size += sum(p.numel() * p.element_size()
                        for p in params.values())
            views.append(CohortView(
                family_name=coh.family_name, module=coh.module,
                params=params, client_ids=ids, n_real=len(ids)))
            view_of[ids] = vi
            row_of[ids] = np.arange(len(ids))
        if (view_of < 0).any():
            missing = np.where(view_of < 0)[0]
            raise ValueError(f"clients {missing.tolist()} belong to no "
                             f"cohort; cannot publish a total serving view")
        self.n_published += 1
        snap = Snapshot(version=self.n_published, published_at=float(t),
                        n_clients=n, views=tuple(views),
                        view_of=view_of, row_of=row_of)
        self._current = snap   # single assignment: the atomic swap
        self.publish_bytes = size
        self.publish_s += time.perf_counter() - t0
        return snap

    def current(self) -> Snapshot:
        snap = self._current
        if snap is None:
            raise RuntimeError("SnapshotStore has no published snapshot "
                               "yet; attach it to an engine "
                               "(engine.attach_snapshots(store)) or call "
                               "store.publish(federation, t) first")
        return snap

    @property
    def version(self) -> int:
        """Version of the current snapshot (0 before the first publish)."""
        return 0 if self._current is None else self._current.version

    def staleness(self, now: float) -> float:
        return self.current().staleness(now)
