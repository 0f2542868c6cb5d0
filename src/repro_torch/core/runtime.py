"""Event-driven virtual-time runtime: Clock/Event, server Triggers, and
the ClientRuntime / ServerBus halves of the federation.

  * ``Clock`` — a monotone virtual clock with a deterministic event queue
    (ties break by event-kind priority, then FIFO). ``SyncClock`` is the
    round-synchronous case: time is the round index and nothing queues.
  * ``ClientRuntime`` — runs the cohorts' gated local steps for a wake
    mask and produces the wire-encoded messenger batch.
  * ``ServerBus`` — merges uploads arriving at arbitrary virtual times
    into ``ServerState`` (stale rows are kept, never dropped; an
    out-of-order upload older than a row's content is superseded), fires
    ``policy_round`` when its ``Trigger`` says so (after every upload,
    every k uploads, on a wall interval, on a quorum of distinct
    uploaders) and puts the targets on the downlink. It meters the wire
    bytes both ways. A round without communication only ``observe``s the
    clients that trained.

The bus's bookkeeping (upload times, counters, wire bytes) is numpy on
the host, as in the reference; only the repository and the targets live
on the device.

``ServerBus(delta=True)`` hands each fire the accumulated mask of rows
uploaded since the last fire, so the policy can take its incremental
graph update; the uplink and downlink codecs are the bus's (else the
federation's, else ``dense32``).
"""
from __future__ import annotations

import abc
import dataclasses
import heapq
from typing import (Any, Callable, Dict, List, Optional, Tuple, Type,
                    Union)

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import wire
from repro_torch.core.client import (sharded_cohort_step,
                                     sharded_messenger_upload)
from repro_torch.core.server import (policy_round, staleness_summary,
                                     upload_messengers)
from repro_torch.data.pipeline import draw_batch_indices
from repro_torch.sharding import ClientMesh, cohort_mesh, place_cohort_stacks

# batch_indices(step, cohort_idx) -> (n_c, B) sample indices; ``step``
# counts inner local steps across wakes
BatchIndices = Callable[[int, int], np.ndarray]

# --------------------------------------------------------------------------
# Clock / Event
# --------------------------------------------------------------------------

# Same-instant ordering: uploads merge before the server's wall tick looks
# at the repository, wakes train after the server settles, evals observe
# the fully-settled instant. Serving events come last: queries admitted at
# t see the instant's settled snapshot, and flush deadlines release after
# the queries they batch.
_KIND_PRIORITY = {"upload": 0, "server-tick": 1, "wake": 2, "eval": 3,
                  "query": 4, "serve-flush": 5}


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    kind: str
    payload: Any = None


class Clock:
    """Monotone virtual clock + deterministic event queue."""

    def __init__(self, t0: float = 0.0):
        self.now = float(t0)
        self._heap: List[Tuple[float, int, int, Event]] = []
        self._seq = 0

    def schedule(self, time: float, kind: str, payload: Any = None) -> None:
        if time < self.now - 1e-9:
            raise ValueError(f"cannot schedule {kind!r} at t={time} in the "
                             f"past (now={self.now})")
        ev = Event(float(time), kind, payload)
        heapq.heappush(self._heap, (ev.time, _KIND_PRIORITY.get(kind, 9),
                                    self._seq, ev))
        self._seq += 1

    def pop_due(self, until: float) -> Optional[Event]:
        """Pop the next event with time <= until and advance ``now`` to it;
        None when nothing is due (later events stay queued)."""
        if self._heap and self._heap[0][0] <= until + 1e-9:
            ev = heapq.heappop(self._heap)[3]
            self.now = max(self.now, ev.time)
            return ev
        return None

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def advance(self, t: float) -> None:
        self.now = max(self.now, float(t))

    def __len__(self) -> int:
        return len(self._heap)


class SyncClock(Clock):
    """The round-synchronous clock: virtual time is the round index and no
    events queue — ``FederationEngine`` advances it as it loops."""


# --------------------------------------------------------------------------
# Server triggers
# --------------------------------------------------------------------------

_TRIGGERS: Dict[str, Type["Trigger"]] = {}


def register_trigger(name: str):
    def deco(cls: Type["Trigger"]) -> Type["Trigger"]:
        if name in _TRIGGERS:
            raise ValueError(f"trigger {name!r} already registered")
        cls.name = name
        _TRIGGERS[name] = cls
        return cls

    return deco


def registered_triggers() -> Tuple[str, ...]:
    return tuple(sorted(_TRIGGERS))


def get_trigger(name: str) -> Type["Trigger"]:
    try:
        return _TRIGGERS[name]
    except KeyError:
        raise KeyError(f"unknown trigger {name!r}; registered: "
                       f"{registered_triggers()}") from None


class Trigger(abc.ABC):
    """When the ServerBus runs ``policy_round``: stateless predicates over
    the bus's upload counters, so triggers compose with any policy."""

    name: str = "?"

    def should_fire(self, t: float, bus: "ServerBus") -> bool:
        """Checked after every upload delivery."""
        return False

    def should_fire_on_tick(self, t: float, bus: "ServerBus") -> bool:
        """Checked at wall ticks (only for triggers with a period)."""
        return False

    def wall_period(self) -> Optional[float]:
        """Virtual-time period between server ticks, or None."""
        return None

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


@register_trigger("every-upload")
class EveryUpload(Trigger):
    """Fire after every delivery (the sync special case)."""

    def should_fire(self, t: float, bus: "ServerBus") -> bool:
        return True


@register_trigger("every-k")
class EveryKUploads(Trigger):
    """Fire once ``k`` client-rows have merged since the last fire."""

    def __init__(self, k: int = 8):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = k

    def should_fire(self, t: float, bus: "ServerBus") -> bool:
        return bus.uploads_since_fire >= self.k

    def __repr__(self) -> str:
        return f"EveryKUploads(k={self.k})"


@register_trigger("interval")
class WallInterval(Trigger):
    """Fire on a virtual-time cadence (every ``period``), provided at
    least one upload arrived since the last fire."""

    def __init__(self, period: float = 1.0):
        if period <= 0:
            raise ValueError(f"period must be > 0, got {period}")
        self.period = float(period)

    def wall_period(self) -> Optional[float]:
        return self.period

    def should_fire_on_tick(self, t: float, bus: "ServerBus") -> bool:
        return True

    def __repr__(self) -> str:
        return f"WallInterval(period={self.period})"


@register_trigger("quorum")
class Quorum(Trigger):
    """Fire once a quorum of *distinct* clients has uploaded since the
    last fire — ``count`` absolute, else ``ceil(frac * n_clients)``."""

    def __init__(self, count: Optional[int] = None, frac: float = 0.5):
        if count is not None and count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {frac}")
        self.count = count
        self.frac = frac

    def needed(self, n_clients: int) -> int:
        if self.count is not None:
            return self.count
        return max(1, int(np.ceil(self.frac * n_clients)))

    def should_fire(self, t: float, bus: "ServerBus") -> bool:
        return (int(bus.fresh_since_fire.sum())
                >= self.needed(bus.fed.n_clients))

    def __repr__(self) -> str:
        return (f"Quorum(count={self.count})" if self.count is not None
                else f"Quorum(frac={self.frac})")


def as_trigger(trigger: Union[None, str, Trigger]) -> Trigger:
    """Coerce None/name/instance into a Trigger (None => every-upload)."""
    if isinstance(trigger, Trigger):
        return trigger
    if isinstance(trigger, str):
        return get_trigger(trigger)()
    return EveryUpload()


# --------------------------------------------------------------------------
# ClientRuntime — the client half
# --------------------------------------------------------------------------

class ClientRuntime:
    """Runs the cohorts' gated local steps and produces messengers.

    One wake = ``config.local_steps`` steps, each over every cohort in
    build order; clients outside the mask stay frozen (params and
    optimizer state). Each (inner step, cohort) draws its batch indices
    from ``batch_indices`` when given — the seam a parity run replays the
    reference's draws through, one split per cohort per step per wake —
    else from the federation's generator. Draws are always at the real
    cohort size, (n_c, B).

    With a client ``mesh`` each cohort is ghost-padded and split into one
    shard a mesh entry at construction (``place_cohort_stacks``); each
    shard steps and uploads on its own device, ghost rows stay outside
    the trainable mask and never upload, and the uploads are gathered to
    the server's device. The draws are the unsharded run's."""

    def __init__(self, federation, policy, config,
                 batch_indices: Optional[BatchIndices] = None,
                 mesh: Optional[ClientMesh] = None):
        self.fed = federation
        self.policy = policy
        self.config = config
        self.batch_indices = batch_indices
        self.step = 0                       # inner steps taken, all wakes
        self.ever_woken = np.zeros(federation.n_clients, bool)
        if mesh is not None:
            # each cohort on its own (sub)mesh: a cohort smaller than the
            # mesh takes its first n_c entries, not ghost rows
            for coh in federation.cohorts:
                place_cohort_stacks(coh, cohort_mesh(mesh, coh.n_clients))

    def _indices(self, ci: int, coh) -> torch.Tensor:
        """(n_c, B) batch indices on the cohort's first shard's device."""
        n_c, m = coh.n_clients, coh.shards[0].data["y"].shape[1]
        b = self.config.batch_size
        if self.batch_indices is not None:
            idx = np.array(self.batch_indices(self.step, ci), np.int64)
            if idx.shape != (n_c, b):
                raise ValueError(f"batch_indices gave shape {idx.shape} for "
                                 f"cohort {ci}, expected {(n_c, b)}")
            with trace.sync("client.batch_indices"):
                return torch.from_numpy(idx).to(coh.device)
        return draw_batch_indices(self.fed.generator, n_c, m, b)

    def local_round(self, mask_np: np.ndarray, use_ref: bool) -> None:
        """One wake of the masked clients, in place."""
        with trace.span("client.step"):
            fed = self.fed
            n, r, c = fed.server.repo_logp.shape
            dev = fed.server.repo_logp.device
            if fed.targets is None:
                fed.targets = torch.full((n, r, c), 1.0 / c,
                                         dtype=torch.float32, device=dev)
            self.ever_woken |= mask_np
            with trace.sync("client.mask"):
                avail = torch.as_tensor(mask_np, dtype=torch.bool,
                                        device=dev)
            for _ in range(self.config.local_steps):
                for ci, coh in enumerate(fed.cohorts):
                    with trace.span("client.batch", cohort=coh.family_name):
                        with trace.sync("client.rows"):
                            rows = torch.as_tensor(coh.padded_ids,
                                                   device=dev)
                        # ghost rows alias the last real client's id;
                        # force them out of the trainable mask regardless
                        on = avail[rows] & (
                            torch.arange(coh.n_rows, device=dev)
                            < coh.n_clients)
                        idx = self._indices(ci, coh)
                        targets = fed.targets[rows]
                    sharded_cohort_step(coh, idx, fed.ref_x, targets, on,
                                        self.policy.rho, use_ref)
                self.step += 1

    @property
    def uplink(self) -> wire.Codec:
        return wire.as_codec(getattr(self.fed, "uplink", None))

    def collect_messengers(self, mask_np: np.ndarray) -> wire.Payload:
        """(N,R,C) messenger batch encoded with the uplink codec; cohorts
        with no masked client are skipped (their rows stay zero and are
        masked out of the merge). The payload's tensors are fresh — none
        is a view of a parameter — so an upload held in flight across
        later wakes still carries the messengers of its own wake."""
        with trace.span("upload.collect"):
            fed = self.fed
            n, r, c = fed.server.repo_logp.shape
            parts, rows = [], []
            for coh in fed.cohorts:
                if not mask_np[coh.client_ids].any():
                    continue
                with trace.span("upload.messengers", cohort=coh.family_name):
                    got, ids = sharded_messenger_upload(
                        coh, fed.ref_x, self.uplink,
                        fed.server.repo_logp.device)
                parts += got
                rows += ids
            if not parts:
                return self.uplink.encode(torch.zeros(
                    (n, r, c), device=fed.server.repo_logp.device))
            with trace.span("upload.assemble"):
                return wire.assemble(parts, rows, n)


# --------------------------------------------------------------------------
# ServerBus — the server half
# --------------------------------------------------------------------------

class ServerBus:
    """Absorbs messenger uploads at arbitrary virtual times and fires
    policy rounds per its trigger.

    ``deliver`` merges the masked rows into the repository and meters
    ``bytes_up`` for every transmitting client (a superseded out-of-order
    upload still burned the link, so it still counts); ``tick`` is the
    wall-interval hook; ``fire`` runs ``policy_round``, wire-codes the
    targets with the downlink codec (clients train on the DECODED
    payload) and charges ``bytes_down`` to the policy's receivers.
    Staleness of every repository row (the virtual age of its newest
    merged content) is summarized at each fire and at eval time.

    ``delta=True`` hands each fire ``fresh_since_fire``, the rows merged
    since the last fire, so the policy can take its incremental graph
    update (``build_graph_delta``) instead of the full rebuild.
    ``selection`` ("exact" or "ivf") is set on the policy, which reads it
    in its delta rounds; a client ``mesh`` is set on it too, and its full
    rebuild splits into one row strip a mesh entry."""

    def __init__(self, federation, policy,
                 trigger: Union[None, str, Trigger] = None,
                 delta: bool = False,
                 uplink: Union[None, str, wire.Codec] = None,
                 downlink: Union[None, str, wire.Codec] = None,
                 selection: Optional[str] = None,
                 mesh: Optional[ClientMesh] = None):
        self.fed = federation
        self.policy = policy
        self.trigger = as_trigger(trigger)
        self.delta = bool(delta)
        if mesh is not None:
            # a policy whose full rebuild splits over the client mesh
            # reads it off itself, as it reads ``selection``
            policy.mesh = mesh
        if selection is not None:
            policy.selection = selection
        # None => follow the federation's codec names (else dense32)
        self._uplink = uplink
        self._downlink = downlink
        self.load_state_dict(None)
        self.last_graph = None
        self.last_staleness: Optional[dict] = None

    @property
    def uplink(self) -> wire.Codec:
        return wire.as_codec(self._uplink if self._uplink is not None
                             else getattr(self.fed, "uplink", None))

    @property
    def downlink(self) -> wire.Codec:
        return wire.as_codec(self._downlink if self._downlink is not None
                             else getattr(self.fed, "downlink", None))

    def deliver(self, t: float, msg: Union[torch.Tensor, wire.Payload],
                uploaded: np.ndarray,
                produced_at: Optional[float] = None) -> bool:
        """Merge one upload batch arriving at ``t``; True if the trigger
        fired a policy round. ``msg`` is normally the clients' wire
        Payload; a raw (N,R,C) tensor is encoded here with the bus's
        uplink codec, so every ingest pays real payload bytes.
        ``produced_at`` is when the messengers were computed (default
        ``t``): staleness tracks the content's age. Newest content wins
        per row: an arrival older than what a row already holds is
        superseded and skipped. The trigger is consulted even for an
        empty batch."""
        with trace.span("upload.merge"):
            if not isinstance(msg, wire.Payload):
                msg = self.uplink.encode(torch.as_tensor(
                    msg, device=self.fed.server.repo_logp.device))
            sent = np.asarray(uploaded, bool)
            self.bytes_up[sent] += wire.bytes_per_messenger(msg)
            pt = t if produced_at is None else produced_at
            up = sent & (pt >= self.last_upload_t)
            fed = self.fed
            fed.server = upload_messengers(fed.server, msg,
                                           torch.as_tensor(up))
            self.last_upload_t = np.where(up, pt, self.last_upload_t)
            k = int(up.sum())
            self.n_uploads += k
            self.uploads_since_fire += k
            self.fresh_since_fire |= up
            fires = bool(self.trigger.should_fire(t, self))
        if fires:
            self.fire(t)
        return fires

    def tick(self, t: float) -> bool:
        """Wall tick: fire if the trigger wants to and new uploads exist
        (an unchanged repository would recompute the same graph)."""
        if self.uploads_since_fire and self.trigger.should_fire_on_tick(
                t, self):
            self.fire(t)
            return True
        return False

    def fire(self, t: float) -> None:
        """grade -> build graph -> emit targets, then the downlink."""
        with trace.span("server.fire"):
            fed = self.fed
            uploaded = self.fresh_since_fire.copy() if self.delta else None
            fed.server, targets, self.last_graph = policy_round(
                fed.server, self.policy, fed.ref_y, uploaded=uploaded)
            with trace.span("server.downlink"):
                payload = self.downlink.encode(targets, domain="prob")
                decoded = wire.decode(payload)
                recv = self.policy.receivers(fed.server, self.last_graph)
                with trace.sync("server.receivers_all"):
                    everyone = bool(recv.all())
                if not everyone:
                    # nothing is sent to excluded rows, so nothing may
                    # arrive: a lossy decode would otherwise turn their
                    # zero target rows into near-uniform distributions
                    # they train toward
                    decoded = torch.where(recv[:, None, None], decoded,
                                          torch.zeros_like(decoded))
                fed.targets = decoded
                with trace.sync("server.receivers"):
                    recv_np = recv.cpu().numpy()
                self.bytes_down[recv_np] += wire.bytes_per_messenger(payload)
            self.n_triggers += 1
            with trace.span("server.staleness"):
                self.last_staleness = self.staleness(t)
            self.uploads_since_fire = 0
            self.fresh_since_fire[:] = False

    def observe(self, t: float, mask_np: np.ndarray) -> None:
        """A round without communication (off the interval, or a policy
        that uses no reference): mark the masked clients active and
        advance the server's round counter; nothing fires."""
        srv = self.fed.server
        with trace.sync("server.observe"):
            up = torch.as_tensor(np.asarray(mask_np, bool),
                                 device=srv.active.device)
        self.fed.server = srv._replace(active=srv.active | up,
                                       round=srv.round + 1)

    def staleness(self, now: float) -> dict:
        with trace.sync("server.staleness"):
            active = self.fed.server.active.cpu().numpy()
        return staleness_summary(self.last_upload_t, active, now)

    # -- checkpointable state ----------------------------------------------
    def state_dict(self) -> dict:
        """The trigger/staleness bookkeeping as plain arrays (copies, so
        the live counters never alias a saved state) and ints. Without it
        a restored every-k or quorum bus double-fires or skips its first
        round, and staleness restarts from -inf."""
        return {
            "last_upload_t": np.array(self.last_upload_t, float),
            "uploads_since_fire": int(self.uploads_since_fire),
            "fresh_since_fire": np.array(self.fresh_since_fire, bool),
            "n_uploads": int(self.n_uploads),
            "n_triggers": int(self.n_triggers),
            "bytes_up": np.array(self.bytes_up, float),
            "bytes_down": np.array(self.bytes_down, float),
        }

    def load_state_dict(self, state: Optional[dict]) -> None:
        """Restore ``state_dict`` output; ``None`` (a legacy checkpoint
        with no bus section) resets every counter to a fresh bus's
        zeros."""
        n = self.fed.n_clients
        if state is None:
            self.last_upload_t = np.full(n, -np.inf)
            self.uploads_since_fire = 0                 # rows merged
            self.fresh_since_fire = np.zeros(n, bool)   # distinct uploaders
            self.n_uploads = 0
            self.n_triggers = 0
            self.bytes_up = np.zeros(n)    # cumulative uplink wire bytes
            self.bytes_down = np.zeros(n)  # cumulative downlink wire bytes
            return
        # np.array copies: the counters are mutated in place
        self.last_upload_t = np.array(state["last_upload_t"], float)
        self.uploads_since_fire = int(state["uploads_since_fire"])
        self.fresh_since_fire = np.array(state["fresh_since_fire"], bool)
        self.n_uploads = int(state["n_uploads"])
        self.n_triggers = int(state["n_triggers"])
        self.bytes_up = np.array(state["bytes_up"], float)
        self.bytes_down = np.array(state["bytes_down"], float)
