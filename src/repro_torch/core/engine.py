"""Config-driven federation engines (Algorithm 1 end-to-end).

``FederationEngine`` owns a ``Federation`` state bundle (cohorts, server
state, targets), a ``ServerPolicy``, a client-availability ``Schedule``
and a ``FederationConfig``; each round is a full-federation wake of the
``ClientRuntime`` followed by an upload that fires the ``ServerBus`` (a
``SyncClock`` and the every-upload trigger).
``AsyncFederationEngine.fit(until=...)`` drives the virtual-clock event
loop instead: clients wake per an ``ArrivalProcess``, uploads land after
their latency and merge on arrival, and the bus fires per its
``Trigger``.

    engine = FederationEngine.build(ds, splits, hetero_mlp_zoo(L, C), None,
                                    sqmd(q=16, k=8),
                                    config=FederationConfig(rounds=40))
    history = engine.fit(splits)

    mixed = FederationEngine.build(
        ds, splits, build_zoo("mlp-s,resnet,transformer,ssm,rglru", L, C),
        "mlp-s:0.4,resnet:0.3,transformer:0.1,ssm:0.1,rglru:0.1",
        sqmd(q=16, k=8))

    async_engine = AsyncFederationEngine.build(
        ds, splits, hetero_mlp_zoo(L, C), None, sqmd(q=16, k=8),
        arrivals=StragglerLatency(fraction=0.3, delay=2.5),
        trigger=Quorum(frac=0.5))
    history = async_engine.fit(splits, until=40.0)

The server lives on one device, the card unless ``device="cpu"`` is
passed. ``FederationConfig(devices=n)`` splits the client axis over a
mesh of n devices of that type (``repro_torch.sharding``: on the card
the first n cards, on the CPU n entries of it): each cohort's rows are
ghost-padded and split into shards that step and upload on their own
devices, and SQMD's full divergence rebuild splits into row strips; the
run equals the unsharded one. Two optional seams carry another run's
draws in: ``init_params={family: stacked numpy params}`` and
``batch_indices(step, cohort_idx) -> (n_c, B)``, ``step`` counting inner
local steps across wakes; without them the port draws from a
``torch.Generator`` seeded by ``seed``. A third, ``mesh=``, takes an
explicit ``ClientMesh`` in place of the one ``devices`` builds, so a
test can run 8 shards on one card.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch import Device, resolve_device, trace
from repro_torch.convert import load_cohort_params, static_weights_from_numpy
from repro_torch.core import graph as graph_mod
from repro_torch.core import wire
from repro_torch.core.client import (Cohort, cohort_accuracy,
                                     cohort_accuracy_masked, cohort_pred)
from repro_torch.core.policies import ServerPolicy, as_policy
from repro_torch.core.protocols import Protocol
from repro_torch.core.runtime import (BatchIndices, ClientRuntime, Clock,
                                      ServerBus, SyncClock, Trigger,
                                      as_trigger)
from repro_torch.core.schedules import (ArrivalProcess, Schedule,
                                        as_arrivals, as_schedule)
from repro_torch.core.server import ServerState, init_server
from repro_torch.data.partition import ClientSplit, pack_cohort
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.models.mlp import MLPConfig, mlp_family
from repro_torch.models.zoo import parse_assignment
from repro_torch.optim import Optimizer, sgd
from repro_torch.sharding import ClientMesh, make_client_mesh

# {family: cohort builder} (a ``Zoo`` or any mapping of builders), or the
# ``hetero_mlp_zoo`` dict of MLPConfig
Families = Mapping[str, Union[MLPConfig, Callable[..., Any]]]
Assignment = Union[None, str, Sequence[str]]


@dataclasses.dataclass
class History:
    """Eval-time trajectory: per eval the round (sync) or nearest virtual
    tick (async), the virtual time, accuracies, graph stats, server rounds
    fired, repository staleness and the cumulative wire bytes."""
    rounds: List[int] = dataclasses.field(default_factory=list)
    mean_acc: List[float] = dataclasses.field(default_factory=list)
    per_client_acc: List[np.ndarray] = dataclasses.field(default_factory=list)
    val_acc: List[float] = dataclasses.field(default_factory=list)
    graph_stats: List[dict] = dataclasses.field(default_factory=list)
    mean_loss: List[float] = dataclasses.field(default_factory=list)
    times: List[float] = dataclasses.field(default_factory=list)
    server_rounds: List[int] = dataclasses.field(default_factory=list)
    staleness: List[dict] = dataclasses.field(default_factory=list)
    bytes_up: List[float] = dataclasses.field(default_factory=list)
    bytes_down: List[float] = dataclasses.field(default_factory=list)

    def final_metrics(self, mask: Optional[np.ndarray] = None) -> dict:
        acc = self.per_client_acc[-1]
        if mask is not None:
            acc = acc[mask]
        return {"acc": float(np.mean(acc)), "std": float(np.std(acc))}

    @property
    def best_round_idx(self) -> int:
        """Model selection by VALIDATION accuracy (test stays untouched)."""
        if self.val_acc:
            return int(np.argmax(self.val_acc))
        return len(self.mean_acc) - 1

    @property
    def selected_acc(self) -> float:
        return self.mean_acc[self.best_round_idx]

    def selected_per_client(self) -> np.ndarray:
        return self.per_client_acc[self.best_round_idx]


@dataclasses.dataclass
class Federation:
    """The state bundle; orchestration lives in FederationEngine."""
    cohorts: List[Cohort]
    server: ServerState
    ref_x: torch.Tensor
    ref_y: torch.Tensor
    n_clients: int
    generator: torch.Generator
    targets: Optional[torch.Tensor] = None          # (N,R,C)
    history: History = dataclasses.field(default_factory=History)
    uplink: str = "dense32"     # wire codec names, client->server and
    downlink: str = "dense32"   # server->client
    static_weights: Optional[torch.Tensor] = None   # D-Dist's graph

    @property
    def device(self) -> torch.device:
        return self.server.repo_logp.device

    def client_rows(self, cohort: Cohort) -> np.ndarray:
        """The federation rows (client ids) of ``cohort``'s clients."""
        return cohort.client_ids


@dataclasses.dataclass
class FederationConfig:
    rounds: int = 40
    batch_size: int = 32
    local_steps: int = 1            # local SGD steps per wake
    eval_every: int = 10
    delta_graph: bool = False       # incremental O(u·N) server graph
    # updates; off by default — the full rebuild is the exact oracle
    selection: str = "exact"        # "exact" dense (N,N) divergence, or
    # "ivf": the approximate top-K index (requires delta_graph)
    uplink: str = "dense32"         # messenger wire codec, client->server
    downlink: str = "dense32"       # target wire codec, server->client
    devices: Optional[int] = None   # split the client axis over this many
    # devices (cohort steps, uploads, the server's divergence rows); None
    # is the one-device path
    verbose: bool = False

    def __post_init__(self):
        if self.rounds < 0:
            raise ValueError(f"rounds must be >= 0, got {self.rounds}")
        for name in ("batch_size", "local_steps", "eval_every"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        if self.devices is not None and self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if self.selection not in ("exact", "ivf"):
            raise ValueError(f"selection must be 'exact' or 'ivf', got "
                             f"{self.selection!r}")
        if self.selection == "ivf" and not self.delta_graph:
            raise ValueError("selection='ivf' requires delta_graph=True: "
                             "the approximate index only exists on the "
                             "incremental build_graph_delta path")
        for which in ("uplink", "downlink"):
            try:
                wire.as_codec(getattr(self, which))
            except KeyError as e:
                raise ValueError(f"{which}: {e}") from None


RoundCallback = Callable[["FederationEngine", int, Dict[str, Any]], None]


def _build_mesh(config: FederationConfig, device: torch.device,
                mesh: Optional[ClientMesh]) -> Optional[ClientMesh]:
    """The client mesh of ``config.devices`` on ``device``'s type (None:
    the one-device path), or the given ``mesh``, which must have
    ``config.devices`` entries of that type."""
    if mesh is None:
        if config.devices is None:
            return None
        return make_client_mesh(config.devices, device=device)
    if config.devices != mesh.size:
        raise ValueError(f"mesh has {mesh.size} entries but "
                         f"config.devices is {config.devices}")
    if mesh.devices[0].type != device.type:
        raise ValueError(f"mesh on {mesh.devices[0].type} for a "
                         f"federation on {device.type}")
    return mesh


def _init_federation(ds: FederatedDataset, splits: Sequence[ClientSplit],
                     families: Families, assignment: Assignment,
                     policy: Union[str, Protocol, ServerPolicy],
                     *, device: Device, seed: int,
                     init_params: Optional[Mapping[str, Mapping]],
                     static_weights=None,
                     optimizer: Optional[Optimizer] = None
                     ) -> Tuple[Federation, ServerPolicy]:
    """families: {name: cohort builder} or {name: MLPConfig}; assignment
    is a per-client list of family names or a spec string (``"fam:w,..."``
    weighted shares, ``"fam,fam"`` round-robin; None round-robins over
    the families), read by ``parse_assignment``. Each cohort trains with
    ``optimizer`` if given, else its family's default (``zoo.optimizers``
    on a ``Zoo``), else SGD at lr 0.05 with momentum 0.9.
    ``init_params={family: stacked numpy params}`` in the reference's
    layout replaces a cohort's draws. ``static_weights`` (numpy or tensor,
    dense (N,N)) is D-Dist's graph; a policy with one-time state that got
    none draws it in ``setup`` from the federation's generator, after the
    cohorts' draws."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    default_opt = optimizer or sgd(0.05, momentum=0.9)
    # an explicit optimizer overrides every family's default
    fam_opts: Mapping[str, Optimizer] = {} if optimizer is not None else (
        getattr(families, "optimizers", None) or {})
    n = ds.n_clients
    assignment = parse_assignment(assignment, list(families), n)
    cohorts = []
    for fam, family in families.items():
        ids = [i for i in range(n) if assignment[i] == fam]
        if not ids:
            continue
        build = mlp_family(family) if isinstance(family, MLPConfig) \
            else family
        model = build(len(ids), device=dev, generator=gen)
        if init_params is not None and fam in init_params:
            load_cohort_params(model, init_params[fam])
        packed = pack_cohort([splits[i] for i in ids])
        data = {"x": torch.as_tensor(packed["x"], dtype=torch.float32,
                                     device=dev),
                "y": torch.as_tensor(packed["y"], dtype=torch.long,
                                     device=dev)}
        opt = fam_opts.get(fam, default_opt)
        cohorts.append(Cohort.whole(fam, model,
                                    opt.init(list(model.parameters())),
                                    ids, data, opt))
    if isinstance(static_weights, np.ndarray):
        static_weights = static_weights_from_numpy(static_weights, dev)
    elif static_weights is not None:
        static_weights = static_weights.to(dev, torch.float32)
    pol = as_policy(policy, static_weights=static_weights)
    if type(pol).setup is not ServerPolicy.setup:
        pol.setup(gen, n)
    fed = Federation(
        cohorts=cohorts, server=init_server(n, len(ds.ref_y), ds.n_classes,
                                            dev),
        ref_x=torch.as_tensor(ds.ref_x, dtype=torch.float32, device=dev),
        ref_y=torch.as_tensor(ds.ref_y, dtype=torch.int32, device=dev),
        n_clients=n, generator=gen,
        static_weights=getattr(pol, "static_weights", None))
    return fed, pol


def _record_metrics(eng, splits: Sequence[ClientSplit], rnd: int, t: float,
                    mask: np.ndarray) -> Dict[str, Any]:
    """Append one eval point to ``eng.history`` (shared by both engines)."""
    acc = eng.evaluate(splits)
    vacc = eng.evaluate(splits, which="val")
    h = eng.history
    h.rounds.append(rnd)
    h.times.append(float(t))
    h.per_client_acc.append(acc)
    h.mean_acc.append(float(acc[mask].mean()))
    h.val_acc.append(float(vacc[mask].mean()))
    h.server_rounds.append(eng.bus.n_triggers)
    stale = eng.bus.staleness(t)
    h.staleness.append(stale)
    h.bytes_up.append(float(eng.bus.bytes_up.sum()))
    h.bytes_down.append(float(eng.bus.bytes_down.sum()))
    metrics: Dict[str, Any] = {
        "round": rnd, "time": float(t), "acc": h.mean_acc[-1],
        "val_acc": h.val_acc[-1], "per_client_acc": acc, "joined": mask,
        "server_rounds": eng.bus.n_triggers, "staleness": stale,
        "bytes_up": h.bytes_up[-1], "bytes_down": h.bytes_down[-1],
    }
    if eng.last_graph is not None:
        h.graph_stats.append(graph_mod.graph_stats(eng.last_graph))
        metrics["graph"] = h.graph_stats[-1]
    return metrics


class FederationEngine:
    """The synchronous federation driver: ``SyncClock``, every-upload
    trigger, one wake per round for the schedule's availability mask."""

    def __init__(self, federation: Federation, policy: ServerPolicy,
                 schedule: Union[None, str, Schedule] = None,
                 config: Optional[FederationConfig] = None,
                 callbacks: Sequence[RoundCallback] = (),
                 batch_indices: Optional[BatchIndices] = None,
                 mesh: Optional[ClientMesh] = None):
        self.fed = federation
        self.policy = policy
        self.schedule = as_schedule(schedule)
        self.config = config or FederationConfig()
        self.callbacks: List[RoundCallback] = list(callbacks)
        self.publish_hooks: List[Callable[[float], None]] = []
        self.clock: Clock = SyncClock()
        federation.uplink = self.config.uplink
        federation.downlink = self.config.downlink
        self.mesh = _build_mesh(self.config, federation.device, mesh)
        self.clients = ClientRuntime(federation, policy, self.config,
                                     batch_indices=batch_indices,
                                     mesh=self.mesh)
        self.bus = ServerBus(federation, policy, trigger="every-upload",
                             delta=self.config.delta_graph,
                             selection=self.config.selection,
                             mesh=self.mesh)

    @property
    def server(self) -> ServerState:
        return self.fed.server

    @property
    def history(self) -> History:
        return self.fed.history

    @property
    def n_clients(self) -> int:
        return self.fed.n_clients

    @property
    def last_graph(self) -> Optional[graph_mod.CollaborationGraph]:
        return self.bus.last_graph

    def attach_snapshots(self, store):
        """Publish serving views of the per-client params into ``store``
        (anything with ``publish(federation, t)``, normally a
        ``repro_torch.serve.SnapshotStore``): once now, then after every
        round (sync) or every wake and server fire (async). Returns the
        store."""
        self.publish_hooks.append(lambda t: store.publish(self.fed, t))
        store.publish(self.fed, float(self.clock.now))
        return store

    def _publish(self, t: float) -> None:
        """Call the publish hooks (``hook(t)``) after params or targets
        moved: every round (sync), every wake and server fire (async)."""
        for hook in self.publish_hooks:
            hook(float(t))

    @classmethod
    def build(cls, ds: FederatedDataset, splits: Sequence[ClientSplit],
              families: Families, assignment: Assignment,
              policy: Union[str, Protocol, ServerPolicy],
              *, config: Optional[FederationConfig] = None,
              schedule: Union[None, str, Schedule] = None, seed: int = 0,
              callbacks: Sequence[RoundCallback] = (),
              device: Device = None,
              init_params: Optional[Mapping[str, Mapping]] = None,
              batch_indices: Optional[BatchIndices] = None,
              static_weights=None,
              optimizer: Optional[Optimizer] = None,
              mesh: Optional[ClientMesh] = None) -> "FederationEngine":
        """``schedule`` is a Schedule, a registered name or None (always
        on); ``device=None`` is the card, and raises without one.
        ``static_weights`` is D-Dist's dense (N,N) graph (numpy or
        tensor); without it D-Dist draws one. ``optimizer`` overrides
        every family's default. ``mesh`` (a test seam) replaces the mesh
        ``config.devices`` would build, e.g. 8 entries of one card; it
        must have ``config.devices`` entries."""
        fed, pol = _init_federation(
            ds, splits, families, assignment, policy, device=device,
            seed=seed, init_params=init_params,
            static_weights=static_weights, optimizer=optimizer)
        return cls(fed, pol, schedule, config=config,
                   callbacks=callbacks, batch_indices=batch_indices,
                   mesh=mesh)

    def run_round(self, rnd: int) -> None:
        """One round, in place: a wake of the available clients
        (distilling toward the targets from round 1 on, if the policy uses
        the reference set), then, every ``interval`` rounds, their upload,
        which fires the server; other rounds only mark them active."""
        with trace.span("round", round=rnd):
            fed = self.fed
            t = float(rnd)
            self.clock.advance(t)
            avail = np.asarray(self.schedule.available(rnd, fed.n_clients),
                               bool)
            uses_ref = self.policy.uses_reference
            self.clients.local_round(avail, use_ref=uses_ref and rnd > 0)
            if uses_ref and rnd % self.policy.interval == 0:
                self.bus.deliver(t, self.clients.collect_messengers(avail),
                                 avail)
            else:
                self.bus.observe(t, avail)
            self._publish(t)

    def evaluate(self, splits: Sequence[ClientSplit],
                 which: str = "test") -> np.ndarray:
        return evaluate(self.fed, splits, which=which)

    def add_callback(self, cb: RoundCallback) -> None:
        """Call ``cb(engine, round, metrics)`` after each evaluation, after
        the callbacks given at construction."""
        self.callbacks.append(cb)

    def _record(self, splits: Sequence[ClientSplit], rnd: int
                ) -> Dict[str, Any]:
        mask = np.asarray(self.schedule.joined(rnd, self.n_clients), bool)
        if not mask.any():
            mask = np.ones_like(mask)
        return _record_metrics(self, splits, rnd, float(rnd), mask)

    def fit(self, splits: Sequence[ClientSplit]) -> History:
        cfg = self.config
        for rnd in range(cfg.rounds):
            self.run_round(rnd)
            if rnd % cfg.eval_every == 0 or rnd == cfg.rounds - 1:
                metrics = self._record(splits, rnd)
                for cb in self.callbacks:
                    cb(self, rnd, metrics)
                if cfg.verbose:
                    print(f"  round {rnd:4d}  "
                          f"acc={self.history.mean_acc[-1]:.4f}")
        return self.history


class AsyncFederationEngine:
    """Event-driven federation driver on a virtual clock.

    Clients wake per an ``ArrivalProcess``; each wake's uploads travel
    with per-client latency (one ``upload`` event per distinct latency)
    and merge into the repository on arrival (stale rows persist until
    overwritten); the ``ServerBus`` fires policy rounds per its
    ``Trigger``. ``fit(until=...)`` drains every event up to a virtual
    horizon and can be called again with a larger one to continue the
    same run; uploads in flight past the horizon stay queued. Evals run
    every ``config.eval_every`` virtual seconds and at the horizon.

    ``handlers`` maps further event kinds on the shared clock to their
    handler; ``publish_hooks`` are called after every wake and every
    server fire."""

    def __init__(self, federation: Federation, policy: ServerPolicy,
                 arrivals: Union[None, str, Schedule, ArrivalProcess] = None,
                 trigger: Union[None, str, Trigger] = None,
                 config: Optional[FederationConfig] = None,
                 callbacks: Sequence[RoundCallback] = (),
                 batch_indices: Optional[BatchIndices] = None,
                 mesh: Optional[ClientMesh] = None):
        if policy.uses_reference and policy.interval != 1:
            raise ValueError(
                f"Protocol.interval={policy.interval} is a "
                f"round-synchronous concept; under the event clock express "
                f"server cadence with a Trigger instead (every-k, "
                f"interval, quorum)")
        self.fed = federation
        self.policy = policy
        self.arrivals = as_arrivals(arrivals)
        self.config = config or FederationConfig()
        self.callbacks: List[RoundCallback] = list(callbacks)
        self.publish_hooks: List[Callable[[float], None]] = []
        self.handlers: Dict[str, Callable[[Any], None]] = {}
        self.clock = Clock()
        federation.uplink = self.config.uplink
        federation.downlink = self.config.downlink
        self.mesh = _build_mesh(self.config, federation.device, mesh)
        self.clients = ClientRuntime(federation, policy, self.config,
                                     batch_indices=batch_indices,
                                     mesh=self.mesh)
        self.bus = ServerBus(federation, policy, trigger=as_trigger(trigger),
                             delta=self.config.delta_graph,
                             selection=self.config.selection,
                             mesh=self.mesh)
        self._seeded_until = -1.0

    server = FederationEngine.server
    history = FederationEngine.history
    n_clients = FederationEngine.n_clients
    last_graph = FederationEngine.last_graph
    evaluate = FederationEngine.evaluate
    add_callback = FederationEngine.add_callback
    attach_snapshots = FederationEngine.attach_snapshots
    _publish = FederationEngine._publish

    @classmethod
    def build(cls, ds: FederatedDataset, splits: Sequence[ClientSplit],
              families: Families, assignment: Assignment,
              policy: Union[str, Protocol, ServerPolicy],
              *, arrivals: Union[None, str, Schedule, ArrivalProcess] = None,
              trigger: Union[None, str, Trigger] = None,
              config: Optional[FederationConfig] = None, seed: int = 0,
              callbacks: Sequence[RoundCallback] = (),
              device: Device = None,
              init_params: Optional[Mapping[str, Mapping]] = None,
              batch_indices: Optional[BatchIndices] = None,
              static_weights=None,
              optimizer: Optional[Optimizer] = None,
              mesh: Optional[ClientMesh] = None
              ) -> "AsyncFederationEngine":
        """``arrivals`` is an ArrivalProcess, a Schedule (shimmed), a
        registered name or None (always on, unit cadence); ``trigger`` a
        Trigger, a name or None (every upload). ``device=None`` is the
        card, and raises without one. ``optimizer`` overrides every
        family's default; ``mesh`` is the test seam of
        ``FederationEngine.build``."""
        fed, pol = _init_federation(
            ds, splits, families, assignment, policy, device=device,
            seed=seed, init_params=init_params,
            static_weights=static_weights, optimizer=optimizer)
        return cls(fed, pol, arrivals=arrivals, trigger=trigger,
                   config=config, callbacks=callbacks,
                   batch_indices=batch_indices, mesh=mesh)

    def _seed_events(self, until: float) -> None:
        lo = self._seeded_until
        n = self.n_clients
        for t, mask in self.arrivals.wakes(n, until):
            if t > lo:
                self.clock.schedule(t, "wake", np.asarray(mask, bool))
        period = self.bus.trigger.wall_period()
        if period is not None:
            k = max(0, int(np.floor(lo / period)) + 1)
            while k * period <= until + 1e-9:
                if k * period > lo:
                    self.clock.schedule(k * period, "server-tick")
                k += 1
        every = float(self.config.eval_every)
        k = max(0, int(np.floor(lo / every)) + 1)
        on_grid = False
        while k * every <= until + 1e-9:
            if k * every > lo:
                self.clock.schedule(k * every, "eval")
                on_grid = on_grid or abs(k * every - until) < 1e-9
            k += 1
        if not on_grid and until > lo:
            self.clock.schedule(until, "eval")   # terminal eval
        # never regress the watermark: a later fit() with a smaller
        # horizon must not re-seed (and replay) events already run
        self._seeded_until = max(lo, until)

    def _dispatch(self, ev, splits: Sequence[ClientSplit]) -> None:
        t = ev.time
        if ev.kind == "wake":
            # an all-False wake still runs the (fully gated) local round
            # and a zero-row upload, so the draws and the server-round
            # cadence match the sync engine round for round
            mask = np.asarray(ev.payload, bool)
            use_ref = (self.policy.uses_reference
                       and self.bus.n_triggers > 0)
            self.clients.local_round(mask, use_ref)
            if self.policy.uses_reference:
                msg = self.clients.collect_messengers(mask)
                lat = np.asarray(
                    self.arrivals.latency(t, mask, self.n_clients), float)
                for d in (np.unique(lat[mask]) if mask.any() else [0.0]):
                    sub = mask & (lat == d) if mask.any() else mask
                    self.clock.schedule(t + float(d), "upload",
                                        (sub, msg, t))
            else:
                self.bus.observe(t, mask)
            self._publish(t)
        elif ev.kind == "upload":
            sub, msg, produced_at = ev.payload
            if self.bus.deliver(t, msg, sub, produced_at=produced_at):
                self._publish(t)
        elif ev.kind == "server-tick":
            if self.bus.tick(t):
                self._publish(t)
        elif ev.kind == "eval":
            self._record(splits, t)
        else:
            handler = self.handlers.get(ev.kind)
            if handler is None:
                raise ValueError(f"no handler for event kind {ev.kind!r} "
                                 f"(registered: {sorted(self.handlers)})")
            handler(ev)

    def _record(self, splits: Sequence[ClientSplit], t: float) -> None:
        rnd = int(round(t))
        joined = self.arrivals.joined(t, self.n_clients)
        mask = (np.asarray(joined, bool) if joined is not None
                else self.clients.ever_woken.copy())
        if not mask.any():
            mask = np.ones(self.n_clients, bool)
        metrics = _record_metrics(self, splits, rnd, t, mask)
        for cb in self.callbacks:
            cb(self, rnd, metrics)
        if self.config.verbose:
            print(f"  t={t:7.2f}  acc={self.history.mean_acc[-1]:.4f}  "
                  f"server_rounds={self.bus.n_triggers}")

    def fit(self, splits: Sequence[ClientSplit],
            until: Optional[float] = None) -> History:
        """Drain every event with virtual time <= ``until`` (default: the
        config's round budget, the sync engine's horizon)."""
        until = float(self.config.rounds - 1) if until is None \
            else float(until)
        self._seed_events(until)
        while (ev := self.clock.pop_due(until)) is not None:
            self._dispatch(ev, splits)
        return self.history


def _pad_cohort_shards(shard_x: List[np.ndarray], shard_y: List[np.ndarray]
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack unequal-length shards: zero rows / -1 labels up to the cohort
    max, and the mask of real samples."""
    m = max(len(y) for y in shard_y)
    lens = np.array([len(y) for y in shard_y])
    xs = np.stack([np.pad(np.asarray(x), [(0, m - len(x))]
                          + [(0, 0)] * (np.asarray(x).ndim - 1))
                   for x in shard_x])
    ys = np.stack([np.pad(np.asarray(y), (0, m - len(y)),
                          constant_values=-1) for y in shard_y])
    mask = np.arange(m)[None, :] < lens[:, None]
    return xs, ys, mask


def evaluate(fed: Federation, splits: Sequence[ClientSplit],
             which: str = "test") -> np.ndarray:
    """Per-client accuracy (N,) on the requested split; unequal shard
    lengths are padded and masked, so no sample is dropped. Sharded
    cohorts evaluate their real rows only (``Cohort.real_forward``)."""
    dev = fed.device
    accs = np.zeros(fed.n_clients)
    for coh in fed.cohorts:
        shard_x = [getattr(splits[i], f"{which}_x") for i in coh.client_ids]
        shard_y = [getattr(splits[i], f"{which}_y") for i in coh.client_ids]
        if len({len(y) for y in shard_y}) == 1:
            a = cohort_accuracy(
                coh.real_forward,
                torch.as_tensor(np.stack(shard_x), dtype=torch.float32,
                                device=dev),
                torch.as_tensor(np.stack(shard_y), device=dev))
        else:
            xs, ys, mask = _pad_cohort_shards(shard_x, shard_y)
            a = cohort_accuracy_masked(
                coh.real_forward, torch.as_tensor(xs, dtype=torch.float32,
                                           device=dev),
                torch.as_tensor(ys, device=dev),
                torch.as_tensor(mask, device=dev))
        accs[coh.client_ids] = a.cpu().numpy()
    return accs


def precision_recall(fed: Federation, splits: Sequence[ClientSplit],
                     n_classes: int) -> Tuple[float, float]:
    """Macro precision/recall over all clients' test shards (Table III)."""
    tp = np.zeros(n_classes)
    fp = np.zeros(n_classes)
    fn = np.zeros(n_classes)
    for coh in fed.cohorts:
        xs, ys, mask = _pad_cohort_shards(
            [splits[i].test_x for i in coh.client_ids],
            [splits[i].test_y for i in coh.client_ids])
        pred = cohort_pred(coh.real_forward, torch.as_tensor(
            xs, dtype=torch.float32, device=fed.device)).cpu().numpy()
        for c in range(n_classes):
            tp[c] += np.sum((pred == c) & (ys == c) & mask)
            fp[c] += np.sum((pred == c) & (ys != c) & mask)
            fn[c] += np.sum((pred != c) & (ys == c) & mask)
    prec = np.mean(tp / np.maximum(tp + fp, 1))
    rec = np.mean(tp / np.maximum(tp + fn, 1))
    return float(prec), float(rec)
