"""The client and server halves of the synchronous federation.

  * ``SyncClock`` — virtual time is the round index.
  * ``ClientRuntime`` — runs the cohorts' gated local steps for a wake
    mask and produces the wire-encoded messenger batch.
  * ``ServerBus`` — merges uploads into ``ServerState`` (stale rows are
    kept, never dropped), fires ``policy_round`` when its trigger says so
    (``EveryUpload``: after every delivery, the sync case) and puts the
    targets on the downlink. It meters the wire bytes both ways. A round
    without communication only ``observe``s the clients that trained.

Clients outside a round's mask stay frozen and keep their stale
repository row.

``ServerBus(delta=True)`` hands each fire the accumulated mask of rows
uploaded since the last fire, so the policy can take its incremental
graph update; the uplink and downlink codecs are the bus's (else the
federation's, else ``dense32``).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core import wire
from repro_torch.core.client import cohort_messenger_upload, cohort_step
from repro_torch.core.server import (policy_round, staleness_summary,
                                     upload_messengers)
from repro_torch.data.pipeline import cohort_batch

# batch_indices(step, cohort_idx) -> (n_c, B) sample indices
BatchIndices = Callable[[int, int], np.ndarray]


class SyncClock:
    """The round-synchronous clock: virtual time is the round index."""

    def __init__(self, t0: float = 0.0):
        self.now = float(t0)

    def advance(self, t: float) -> None:
        self.now = max(self.now, float(t))


class EveryUpload:
    """Fire the server after every delivery (the sync special case)."""

    def should_fire(self, t: float, bus: "ServerBus") -> bool:
        return True

    def __repr__(self) -> str:
        return "EveryUpload()"


class ClientRuntime:
    """Runs the cohorts' gated local steps and produces messengers.

    One wake = one step of every cohort, cohorts in build order; clients
    outside the mask stay frozen (params and optimizer state). Each
    (step, cohort) draws its batch indices from ``batch_indices`` when
    given (the seam a parity run replays the reference's draws through),
    else from the federation's generator."""

    def __init__(self, federation, policy, config,
                 batch_indices: Optional[BatchIndices] = None):
        self.fed = federation
        self.policy = policy
        self.config = config
        self.batch_indices = batch_indices
        self.step = 0

    def _indices(self, ci: int, coh) -> torch.Tensor:
        n_c, m = coh.data["y"].shape
        b = self.config.batch_size
        if self.batch_indices is not None:
            idx = np.array(self.batch_indices(self.step, ci), np.int64)
            if idx.shape != (n_c, b):
                raise ValueError(f"batch_indices gave shape {idx.shape} for "
                                 f"cohort {ci}, expected {(n_c, b)}")
            return torch.from_numpy(idx)
        gen = self.fed.generator
        return torch.randint(0, m, (n_c, b), generator=gen,
                             device=gen.device)

    def local_round(self, mask_np: np.ndarray, use_ref: bool) -> None:
        """One local step for the masked clients, in place."""
        fed = self.fed
        n, r, c = fed.server.repo_logp.shape
        dev = fed.server.repo_logp.device
        if fed.targets is None:
            fed.targets = torch.full((n, r, c), 1.0 / c,
                                     dtype=torch.float32, device=dev)
        avail = torch.as_tensor(mask_np, dtype=torch.bool, device=dev)
        for ci, coh in enumerate(fed.cohorts):
            batch = cohort_batch(coh.data, self._indices(ci, coh))
            rows = torch.as_tensor(coh.client_ids, device=dev)
            coh.opt_state, _ = cohort_step(
                coh.model, fed.optimizer, coh.opt_state, batch["x"],
                batch["y"], fed.ref_x, fed.targets[rows], avail[rows],
                self.policy.rho, use_ref)
        self.step += 1

    @property
    def uplink(self) -> wire.Codec:
        return wire.as_codec(getattr(self.fed, "uplink", None))

    def collect_messengers(self, mask_np: np.ndarray) -> wire.Payload:
        """(N,R,C) messenger batch encoded with the uplink codec; cohorts
        with no masked client are skipped (their rows stay zero and are
        masked out of the merge)."""
        fed = self.fed
        n, r, c = fed.server.repo_logp.shape
        parts, rows = [], []
        for coh in fed.cohorts:
            if not mask_np[coh.client_ids].any():
                continue
            parts.append(cohort_messenger_upload(coh.model, fed.ref_x,
                                                 codec=self.uplink))
            rows.append(coh.client_ids)
        if not parts:
            return self.uplink.encode(torch.zeros(
                (n, r, c), device=fed.server.repo_logp.device))
        return wire.assemble(parts, rows, n)


class ServerBus:
    """Absorbs messenger uploads and fires policy rounds per its trigger.

    ``deliver`` merges the masked rows into the repository and meters
    ``bytes_up`` for every transmitting client; ``fire`` runs
    ``policy_round``, wire-codes the targets with the downlink codec
    (clients train on the DECODED payload) and charges ``bytes_down`` to
    the policy's receivers.

    ``delta=True`` hands each fire ``fresh_since_fire``, the rows merged
    since the last fire, so the policy can take its incremental graph
    update (``build_graph_delta``) instead of the full rebuild.
    ``selection`` ("exact" or "ivf") is set on the policy, which reads it
    in its delta rounds."""

    def __init__(self, federation, policy, delta: bool = False,
                 uplink: Union[None, str, wire.Codec] = None,
                 downlink: Union[None, str, wire.Codec] = None,
                 selection: Optional[str] = None):
        self.fed = federation
        self.policy = policy
        self.trigger = EveryUpload()
        self.delta = bool(delta)
        if selection is not None:
            policy.selection = selection
        # None => follow the federation's codec names (else dense32)
        self._uplink = uplink
        self._downlink = downlink
        n = federation.n_clients
        self.last_upload_t = np.full(n, -np.inf)
        self.uploads_since_fire = 0                 # rows merged
        self.fresh_since_fire = np.zeros(n, bool)   # distinct uploaders
        self.n_triggers = 0
        self.bytes_up = np.zeros(n)
        self.bytes_down = np.zeros(n)
        self.last_graph = None

    @property
    def uplink(self) -> wire.Codec:
        return wire.as_codec(self._uplink if self._uplink is not None
                             else getattr(self.fed, "uplink", None))

    @property
    def downlink(self) -> wire.Codec:
        return wire.as_codec(self._downlink if self._downlink is not None
                             else getattr(self.fed, "downlink", None))

    def deliver(self, t: float, msg: wire.Payload,
                uploaded: np.ndarray) -> bool:
        """Merge one upload batch arriving at ``t``; True if the trigger
        fired a policy round. The trigger is consulted even for an empty
        batch."""
        up = np.asarray(uploaded, bool)
        self.bytes_up[up] += wire.bytes_per_messenger(msg)
        fed = self.fed
        fed.server = upload_messengers(fed.server, msg, torch.as_tensor(up))
        self.last_upload_t = np.where(up, t, self.last_upload_t)
        self.uploads_since_fire += int(up.sum())
        self.fresh_since_fire |= up
        if self.trigger.should_fire(t, self):
            self.fire(t)
            return True
        return False

    def fire(self, t: float) -> None:
        """grade -> build graph -> emit targets, then the downlink."""
        fed = self.fed
        uploaded = self.fresh_since_fire.copy() if self.delta else None
        fed.server, targets, self.last_graph = policy_round(
            fed.server, self.policy, fed.ref_y, uploaded=uploaded)
        payload = self.downlink.encode(targets, domain="prob")
        decoded = wire.decode(payload)
        recv = self.policy.receivers(fed.server, self.last_graph)
        if not bool(recv.all()):
            # nothing is sent to excluded rows, so nothing may arrive: a
            # lossy decode would otherwise turn their zero target rows
            # into near-uniform distributions they train toward
            decoded = torch.where(recv[:, None, None], decoded,
                                  torch.zeros_like(decoded))
        fed.targets = decoded
        self.bytes_down[recv.cpu().numpy()] += \
            wire.bytes_per_messenger(payload)
        self.n_triggers += 1
        self.uploads_since_fire = 0
        self.fresh_since_fire[:] = False

    def observe(self, t: float, mask_np: np.ndarray) -> None:
        """A round without communication (off the interval, or a policy
        that uses no reference): mark the masked clients active and
        advance the server's round counter; nothing fires."""
        srv = self.fed.server
        up = torch.as_tensor(np.asarray(mask_np, bool),
                             device=srv.active.device)
        self.fed.server = srv._replace(active=srv.active | up,
                                       round=srv.round + 1)

    def staleness(self, now: float) -> dict:
        return staleness_summary(self.last_upload_t,
                                 self.fed.server.active.cpu().numpy(), now)
