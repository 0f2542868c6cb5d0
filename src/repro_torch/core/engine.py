"""Config-driven synchronous federation engine (Algorithm 1 end-to-end).

``FederationEngine`` owns a ``Federation`` state bundle (cohorts, server
state, targets), a ``ServerPolicy``, a client-availability ``Schedule``
and a ``FederationConfig``; each round is a full-federation wake of the
``ClientRuntime`` followed by an upload that fires the ``ServerBus``.

    engine = FederationEngine.build(ds, splits, hetero_mlp_zoo(L, C), None,
                                    sqmd(q=16, k=8),
                                    config=FederationConfig(rounds=40))
    history = engine.fit(splits)

Everything lives on one device, the card unless ``device="cpu"`` is
passed. Two optional seams carry another run's draws in:
``init_params={family: stacked numpy params}`` and
``batch_indices(step, cohort_idx) -> (n_c, B)``; without them the port
draws from a ``torch.Generator`` seeded by ``seed``.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch import Device, resolve_device
from repro_torch.convert import (cohort_params_from_numpy,
                                 static_weights_from_numpy)
from repro_torch.core import graph as graph_mod
from repro_torch.core import wire
from repro_torch.core.client import (Cohort, cohort_accuracy,
                                     cohort_accuracy_masked, cohort_pred)
from repro_torch.core.policies import ServerPolicy, as_policy
from repro_torch.core.protocols import Protocol
from repro_torch.core.runtime import (BatchIndices, ClientRuntime,
                                      ServerBus, SyncClock)
from repro_torch.core.schedules import AlwaysOn, Schedule
from repro_torch.core.server import ServerState, init_server
from repro_torch.data.partition import ClientSplit, pack_cohort
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.models.mlp import CohortMLP, MLPConfig
from repro_torch.optim import Optimizer, sgd


@dataclasses.dataclass
class History:
    """Eval-time trajectory: per eval the round, virtual time, accuracies,
    graph stats, server rounds fired, repository staleness and the
    cumulative wire bytes."""
    rounds: List[int] = dataclasses.field(default_factory=list)
    mean_acc: List[float] = dataclasses.field(default_factory=list)
    per_client_acc: List[np.ndarray] = dataclasses.field(default_factory=list)
    val_acc: List[float] = dataclasses.field(default_factory=list)
    graph_stats: List[dict] = dataclasses.field(default_factory=list)
    times: List[float] = dataclasses.field(default_factory=list)
    server_rounds: List[int] = dataclasses.field(default_factory=list)
    staleness: List[dict] = dataclasses.field(default_factory=list)
    bytes_up: List[float] = dataclasses.field(default_factory=list)
    bytes_down: List[float] = dataclasses.field(default_factory=list)

    @property
    def best_round_idx(self) -> int:
        """Model selection by VALIDATION accuracy (test stays untouched)."""
        if self.val_acc:
            return int(np.argmax(self.val_acc))
        return len(self.mean_acc) - 1

    @property
    def selected_acc(self) -> float:
        return self.mean_acc[self.best_round_idx]


@dataclasses.dataclass
class Federation:
    """The state bundle; orchestration lives in FederationEngine."""
    cohorts: List[Cohort]
    server: ServerState
    ref_x: torch.Tensor
    ref_y: torch.Tensor
    optimizer: Optimizer
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


@dataclasses.dataclass
class FederationConfig:
    rounds: int = 40
    batch_size: int = 32
    eval_every: int = 10
    delta_graph: bool = False       # incremental O(u·N) server graph
    # updates; off by default — the full rebuild is the exact oracle
    selection: str = "exact"        # "exact" dense (N,N) divergence, or
    # "ivf": the approximate top-K index (requires delta_graph)
    uplink: str = "dense32"         # messenger wire codec, client->server
    downlink: str = "dense32"       # target wire codec, server->client
    verbose: bool = False

    def __post_init__(self):
        if self.rounds < 0:
            raise ValueError(f"rounds must be >= 0, got {self.rounds}")
        for name in ("batch_size", "eval_every"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
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


def _init_federation(ds: FederatedDataset, splits: Sequence[ClientSplit],
                     families: Mapping[str, MLPConfig],
                     assignment: Optional[Sequence[str]],
                     policy: Union[str, Protocol, ServerPolicy],
                     *, device: Device, seed: int,
                     init_params: Optional[Mapping[str, Mapping]],
                     static_weights=None
                     ) -> Tuple[Federation, ServerPolicy]:
    """families: {name: MLPConfig}; assignment[n] = family of client n
    (None: round-robin over the families). Every client trains with SGD,
    lr 0.05, momentum 0.9 (the reference's default). ``static_weights``
    (numpy or tensor, dense (N,N)) is D-Dist's graph; a policy with
    one-time state that got none draws it in ``setup`` from the
    federation's generator, after the cohorts' draws."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    opt = sgd(0.05, momentum=0.9)
    n = ds.n_clients
    names = list(families)
    if assignment is None:
        assignment = [names[i % len(names)] for i in range(n)]
    if len(assignment) != n:
        raise ValueError(f"assignment has {len(assignment)} entries for "
                         f"{n} clients")
    unknown = sorted(set(assignment) - set(names))
    if unknown:
        raise ValueError(f"assignment names families not in the zoo: "
                         f"{unknown}; zoo has {names}")
    cohorts = []
    for fam, cfg in families.items():
        ids = [i for i in range(n) if assignment[i] == fam]
        if not ids:
            continue
        model = CohortMLP(cfg, len(ids), device=dev, generator=gen)
        if init_params is not None and fam in init_params:
            model.load_layers(cohort_params_from_numpy(init_params[fam]))
        packed = pack_cohort([splits[i] for i in ids])
        data = {"x": torch.as_tensor(packed["x"], dtype=torch.float32,
                                     device=dev),
                "y": torch.as_tensor(packed["y"], dtype=torch.long,
                                     device=dev)}
        cohorts.append(Cohort(fam, model, opt.init(list(model.parameters())),
                              np.asarray(ids), data))
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
        optimizer=opt, n_clients=n, generator=gen,
        static_weights=getattr(pol, "static_weights", None))
    return fed, pol


class FederationEngine:
    """The synchronous federation driver: ``SyncClock``, every-upload
    trigger, one wake per round for the schedule's availability mask."""

    def __init__(self, federation: Federation, policy: ServerPolicy,
                 schedule: Schedule,
                 config: Optional[FederationConfig] = None,
                 callbacks: Sequence[RoundCallback] = (),
                 batch_indices: Optional[BatchIndices] = None):
        self.fed = federation
        self.policy = policy
        self.schedule = schedule
        self.config = config or FederationConfig()
        self.callbacks: List[RoundCallback] = list(callbacks)
        self.clock = SyncClock()
        federation.uplink = self.config.uplink
        federation.downlink = self.config.downlink
        self.clients = ClientRuntime(federation, policy, self.config,
                                     batch_indices=batch_indices)
        self.bus = ServerBus(federation, policy,
                             delta=self.config.delta_graph,
                             selection=self.config.selection)

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

    @classmethod
    def build(cls, ds: FederatedDataset, splits: Sequence[ClientSplit],
              families: Mapping[str, MLPConfig],
              assignment: Optional[Sequence[str]],
              policy: Union[str, Protocol, ServerPolicy],
              *, config: Optional[FederationConfig] = None,
              schedule: Optional[Schedule] = None, seed: int = 0,
              callbacks: Sequence[RoundCallback] = (),
              device: Device = None,
              init_params: Optional[Mapping[str, Mapping]] = None,
              batch_indices: Optional[BatchIndices] = None,
              static_weights=None) -> "FederationEngine":
        """``schedule=None`` is always-on; ``device=None`` is the card,
        and raises without one. ``static_weights`` is D-Dist's dense
        (N,N) graph (numpy or tensor); without it D-Dist draws one."""
        fed, pol = _init_federation(
            ds, splits, families, assignment, policy, device=device,
            seed=seed, init_params=init_params,
            static_weights=static_weights)
        return cls(fed, pol, schedule or AlwaysOn(), config=config,
                   callbacks=callbacks, batch_indices=batch_indices)

    def run_round(self, rnd: int) -> None:
        """One round, in place: a local step for the available clients
        (distilling toward the targets from round 1 on, if the policy uses
        the reference set), then, every ``interval`` rounds, their upload,
        which fires the server; other rounds only mark them active."""
        fed = self.fed
        t = float(rnd)
        self.clock.advance(t)
        avail = np.asarray(self.schedule.available(rnd, fed.n_clients), bool)
        uses_ref = self.policy.uses_reference
        self.clients.local_round(avail, use_ref=uses_ref and rnd > 0)
        if uses_ref and rnd % self.policy.interval == 0:
            self.bus.deliver(t, self.clients.collect_messengers(avail), avail)
        else:
            self.bus.observe(t, avail)

    def evaluate(self, splits: Sequence[ClientSplit],
                 which: str = "test") -> np.ndarray:
        return evaluate(self.fed, splits, which=which)

    def _record(self, splits: Sequence[ClientSplit], rnd: int
                ) -> Dict[str, Any]:
        mask = np.asarray(self.schedule.joined(rnd, self.n_clients), bool)
        if not mask.any():
            mask = np.ones_like(mask)
        acc = self.evaluate(splits)
        vacc = self.evaluate(splits, which="val")
        h = self.history
        h.rounds.append(rnd)
        h.times.append(float(rnd))
        h.per_client_acc.append(acc)
        h.mean_acc.append(float(acc[mask].mean()))
        h.val_acc.append(float(vacc[mask].mean()))
        h.server_rounds.append(self.bus.n_triggers)
        stale = self.bus.staleness(float(rnd))
        h.staleness.append(stale)
        h.bytes_up.append(float(self.bus.bytes_up.sum()))
        h.bytes_down.append(float(self.bus.bytes_down.sum()))
        metrics: Dict[str, Any] = {
            "round": rnd, "time": float(rnd), "acc": h.mean_acc[-1],
            "val_acc": h.val_acc[-1], "per_client_acc": acc, "joined": mask,
            "server_rounds": self.bus.n_triggers, "staleness": stale,
            "bytes_up": h.bytes_up[-1], "bytes_down": h.bytes_down[-1],
        }
        if self.last_graph is not None:
            h.graph_stats.append(graph_mod.graph_stats(self.last_graph))
            metrics["graph"] = h.graph_stats[-1]
        return metrics

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
    lengths are padded and masked, so no sample is dropped."""
    dev = fed.device
    accs = np.zeros(fed.n_clients)
    for coh in fed.cohorts:
        shard_x = [getattr(splits[i], f"{which}_x") for i in coh.client_ids]
        shard_y = [getattr(splits[i], f"{which}_y") for i in coh.client_ids]
        if len({len(y) for y in shard_y}) == 1:
            a = cohort_accuracy(
                coh.model,
                torch.as_tensor(np.stack(shard_x), dtype=torch.float32,
                                device=dev),
                torch.as_tensor(np.stack(shard_y), device=dev))
        else:
            xs, ys, mask = _pad_cohort_shards(shard_x, shard_y)
            a = cohort_accuracy_masked(
                coh.model, torch.as_tensor(xs, dtype=torch.float32,
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
        pred = cohort_pred(coh.model, torch.as_tensor(
            xs, dtype=torch.float32, device=fed.device)).cpu().numpy()
        for c in range(n_classes):
            tp[c] += np.sum((pred == c) & (ys == c) & mask)
            fp[c] += np.sum((pred == c) & (ys != c) & mask)
            fn[c] += np.sum((pred != c) & (ys == c) & mask)
    prec = np.mean(tp / np.maximum(tp + fp, 1))
    rec = np.mean(tp / np.maximum(tp + fn, 1))
    return float(prec), float(rec)
