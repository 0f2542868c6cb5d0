"""QueryRuntime — serving on the training event loop.

The paper's asynchronous on-device setting, end-to-end: the SAME virtual
clock that wakes clients for local rounds and fires server rounds also
carries query traffic, so serving *contends* with training — a burst of
queries lands between an upload and its policy fire and is answered
from the last published snapshot, observably stale.

Event kinds (priorities in ``repro_torch.core.runtime._KIND_PRIORITY``
put them after training events at the same instant, so queries always
see the instant's fully-settled snapshot):

  query        (t, mask) — the masked clients each issue one query; the
               requests enter the MicroBatchQueue, which may release
               immediately (full batch / zero-wait policy) or set a
               max-wait flush deadline
  serve-flush  a deadline set by an earlier push: release every due
               batch through the QueryEngine

Per-request records capture the full serving story: virtual queue wait,
wall compute seconds of the batch's forward, snapshot version and
staleness, batch/bucket shape, and queue depth at admission.
``summarize_records`` turns them into p50/p99 latency, throughput and
queue-depth numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from repro_torch.core.schedules import ArrivalProcess, as_arrivals
from repro_torch.serve.engine import QueryEngine
from repro_torch.serve.queue import (BatchPolicy, MicroBatchQueue,
                                     QueryRequest, as_batch_policy)
from repro_torch.serve.snapshot import SnapshotStore


def summarize_records(records: List[dict],
                      horizon: Optional[float] = None) -> dict:
    """Aggregate per-request records into the serving metrics.

    ``latency_s`` per request = virtual queue wait + wall compute
    seconds of its batch's forward (virtual and wall seconds share the
    unit by convention: one virtual tick == one second)."""
    if not records:
        return {"n_served": 0}
    lat = np.asarray([r["latency_s"] for r in records])
    wait = np.asarray([r["queue_wait_s"] for r in records])
    stale = np.asarray([r["staleness"] for r in records])
    depth = np.asarray([r["depth_at_admission"] for r in records])
    batch = np.asarray([r["batch_size"] for r in records])
    compute = sum(r["compute_s"] / r["batch_size"] for r in records)
    out = {
        "n_served": len(records),
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "latency_mean_s": float(lat.mean()),
        "queue_wait_p99_s": float(np.percentile(wait, 99)),
        "compute_wall_s": float(compute),
        "throughput_compute_qps": float(len(records) / max(compute, 1e-9)),
        "mean_batch": float(batch.mean()),
        "queue_depth_mean": float(depth.mean()),
        "queue_depth_max": int(depth.max()),
        "staleness_mean": float(stale.mean()),
        "staleness_max": float(stale.max()),
        "versions_served": len({r["version"] for r in records}),
    }
    if horizon:
        out["throughput_virtual_qps"] = float(len(records) / horizon)
    return out


class QueryRuntime:
    """Drives query traffic through an ``AsyncFederationEngine``'s clock.

    Construction wires everything together: a ``SnapshotStore`` attached
    to the engine's publish hooks (so training publishes fresh params
    into serving), a ``QueryEngine`` over that store, a
    ``MicroBatchQueue`` under the given batch policy, and the query
    ``workload`` (any registered ArrivalProcess — ``"query-poisson"``,
    ``"query-diurnal"``, or a training-style process for stress tests).

    ``run(splits, until)`` seeds the query events and drains the shared
    event loop — training wakes, uploads, server fires, evals, queries,
    and flushes interleave in virtual-time order."""

    def __init__(self, engine,
                 workload: Union[str, ArrivalProcess] = "query-poisson",
                 policy: Union[None, str, BatchPolicy] = None,
                 store: Optional[SnapshotStore] = None,
                 features: Optional[Callable[[int, int],
                                             np.ndarray]] = None,
                 bucket_floor: int = 1, max_bucket: int = 128):
        self.engine = engine
        self.store = store if store is not None else SnapshotStore()
        engine.attach_snapshots(self.store)
        self.workload = as_arrivals(workload)
        self.queue = MicroBatchQueue(as_batch_policy(policy))
        self.qengine = QueryEngine(self.store, bucket_floor=bucket_floor,
                                   max_bucket=max_bucket)
        self.features = features
        engine.handlers["query"] = self._on_query
        engine.handlers["serve-flush"] = self._on_flush
        self.records: List[dict] = []
        self._counts = np.zeros(engine.n_clients, np.int64)
        self._admission_depth: Dict[int, int] = {}
        self._seq = 0
        self._seeded_until = -1.0

    # -- event seeding -----------------------------------------------------
    def seed_queries(self, until: float) -> int:
        """Schedule every query wake in (seeded_until, until]; returns
        the number of query events scheduled."""
        if self.features is None:
            raise ValueError("QueryRuntime has no feature source; pass "
                             "features=split_query_stream(splits) or a "
                             "custom (client_id, k) -> features callable")
        n = 0
        for t, mask in self.workload.wakes(self.engine.n_clients, until):
            if t > self._seeded_until:
                self.engine.clock.schedule(t, "query",
                                           np.asarray(mask, bool))
                n += 1
        self._seeded_until = max(self._seeded_until, until)
        return n

    # -- event handlers ----------------------------------------------------
    def _on_query(self, ev) -> None:
        t = ev.time
        mask = np.asarray(ev.payload, bool)
        reqs = []
        for cid in np.where(mask)[0]:
            reqs.append(QueryRequest(
                client_id=int(cid),
                x=self.features(int(cid), int(self._counts[cid])),
                t_arrival=t, seq=self._seq))
            self._counts[cid] += 1
            self._seq += 1
        depth_before = self.queue.depth
        deadline = self.queue.push(reqs, t)
        for r in reqs:
            self._admission_depth[r.seq] = depth_before
        if deadline is not None:
            if deadline <= t + 1e-9:
                self._flush(t)
            else:
                self.engine.clock.schedule(deadline, "serve-flush")

    def _on_flush(self, ev) -> None:
        self._flush(ev.time)

    def _flush(self, t: float) -> None:
        for batch in self.queue.pop_due(t):
            res = self.qengine.serve([r.client_id for r in batch],
                                     np.stack([r.x for r in batch]), t)
            share = res.compute_s   # every request waits the whole batch
            for r, pred in zip(batch, res.preds):
                wait = t - r.t_arrival
                self.records.append({
                    "seq": r.seq, "client_id": r.client_id,
                    "t_arrival": r.t_arrival, "t_served": t,
                    "queue_wait_s": wait,
                    "compute_s": res.compute_s,
                    "latency_s": wait + share,
                    "pred": int(pred),
                    "version": res.version,
                    "staleness": res.staleness,
                    "batch_size": res.n,
                    "buckets": res.buckets,
                    "depth_at_admission":
                        self._admission_depth.pop(r.seq, 0),
                })
        # an over-capacity flush can leave a fresh partial batch behind;
        # re-arm its max-wait deadline (duplicate flush events are
        # harmless — pop_due of an empty/undue queue is a no-op)
        nxt = self.queue.next_deadline()
        if nxt is not None:
            self.engine.clock.schedule(max(nxt, t), "serve-flush")

    # -- the train-and-serve loop ------------------------------------------
    def run(self, splits, until: float):
        """Seed queries to the horizon and drain the shared event loop
        (training events included) — the full train-and-serve run."""
        self.seed_queries(float(until))
        return self.engine.fit(splits, until=float(until))

    def summary(self, horizon: Optional[float] = None) -> dict:
        out = summarize_records(self.records, horizon=horizon)
        out["policy"] = repr(self.queue.policy)
        out["workload"] = repr(self.workload)
        out["n_pushed"] = self.queue.n_pushed
        out["n_pending"] = self.queue.depth
        out["queue_max_depth"] = self.queue.max_depth
        out["snapshots_published"] = self.store.n_published
        return out
