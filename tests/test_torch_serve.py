"""The port's serving subsystem: the snapshot store, the bucketed
QueryEngine, the micro-batching queue, the query workloads, QueryRuntime
on the event clock and the ``serve_federation`` CLI, each against the
reference's ``repro.serve`` where the reference has a counterpart.

Snapshot, engine and queue semantics are the reference's tests
(``tests/test_serve.py``, ``tests/test_serve_queue.py``) on the port, but
the sharded ones and the jit-cache one (the port has no jit, and no mesh).
The port's train-and-serve run gets the reference's initial params and
batch draws (``test_torch_async.build_both``); the query workloads and the
queue are numpy and host code, so both runs see the same queries, batches
and snapshot versions, and the served logits agree within LOGIT_TOL.
"""
import json
import sys

import numpy as np
import pytest
import torch

import repro.serve as J
import repro_torch.serve as T
from repro.launch import serve_federation as jserve_federation
from repro_torch.core import (AsyncFederationEngine, FederationConfig,
                              FederationEngine, get_arrivals, sqmd)
from repro_torch.data import make_splits, pad_like
from repro_torch.launch import serve_federation
from repro_torch.models import hetero_mlp_zoo
from repro_torch.serve import (DiurnalQueries, Immediate, MicroBatch,
                               MicroBatchQueue, PoissonQueries, QueryEngine,
                               QueryRequest, QueryRuntime, SnapshotStore,
                               bucket_size, split_query_stream)
from test_torch_async import _sqmd, build_both
from test_torch_engine import LOGIT_TOL

CFG = dict(rounds=3, batch_size=8, eval_every=2)


@pytest.fixture(scope="module")
def setup_small():
    ds = pad_like(samples_per_client=16, ref_size=16, length=16)
    splits = make_splits(ds, seed=0)
    zoo = hetero_mlp_zoo(ds.feature_len, ds.n_classes)
    assignment = [list(zoo)[i % 3] for i in range(ds.n_clients)]
    return ds, splits, zoo, assignment


def _sync(setup, seed):
    ds, splits, zoo, assignment = setup
    return FederationEngine.build(ds, splits, zoo, assignment,
                                  sqmd(q=8, k=4),
                                  config=FederationConfig(**CFG), seed=seed,
                                  device="cpu")


@pytest.fixture(scope="module")
def trained(setup_small):
    """A short-trained sync engine with an attached snapshot store."""
    eng = _sync(setup_small, 7)
    store = eng.attach_snapshots(SnapshotStore())
    eng.fit(setup_small[1])
    return eng, store, setup_small[1]


def eval_forward(coh, splits):
    """``engine.evaluate``'s forward, logits kept: the cohort module over
    every client's test shard."""
    xs = torch.from_numpy(np.stack([splits[int(c)].test_x
                                    for c in coh.client_ids]))
    with torch.no_grad():
        return coh.model(xs).numpy()


# --- snapshot store semantics ---------------------------------------------

def test_store_empty_until_first_publish():
    store = SnapshotStore()
    assert store.version == 0
    with pytest.raises(RuntimeError, match="no published snapshot"):
        store.current()


def test_publish_versions_monotone(trained):
    eng, store, _ = trained
    # attach publishes once, then one publish per round
    assert store.n_published == CFG["rounds"] + 1
    assert store.version == store.n_published
    assert store.current().published_at == float(CFG["rounds"] - 1)


def test_publish_counts_its_copies(trained):
    eng, store, _ = trained
    size = sum(p.numel() * 4 for c in eng.fed.cohorts
               for p in c.model.parameters())
    assert store.publish_bytes == size and store.publish_s > 0.0


def test_staleness_is_virtual_age(trained):
    _, store, _ = trained
    snap = store.current()
    assert snap.staleness(snap.published_at) == 0.0
    assert snap.staleness(snap.published_at + 2.5) == 2.5
    assert snap.staleness(snap.published_at - 1.0) == 0.0  # clamped


def test_snapshot_routing_total_and_real_only(trained):
    _, store, _ = trained
    snap = store.current()
    assert (snap.view_of >= 0).all()
    for cid in range(snap.n_clients):
        view = snap.views[int(snap.view_of[cid])]
        row = int(snap.row_of[cid])
        assert row < view.n_real
        assert int(view.client_ids[row]) == cid


def test_old_snapshot_immutable_after_more_training(setup_small):
    """The cohort step updates params in place; a published snapshot holds
    copies, so more training leaves it as it was."""
    eng = _sync(setup_small, 3)
    store = eng.attach_snapshots(SnapshotStore())
    old = store.current()
    kept = {k: v.clone() for k, v in old.params_for(0).items()}
    live = dict(eng.fed.cohorts[0].model.named_parameters())
    eng.fit(setup_small[1])                # params move, versions advance
    assert store.version > old.version
    moved = False
    for k, v in old.params_for(0).items():
        assert torch.equal(v, kept[k]), k
        moved |= not torch.equal(live[k][0], kept[k])
    assert moved                           # the live params did change


def test_params_for_matches_cohort_row(trained):
    eng, store, _ = trained
    snap = store.current()
    coh = eng.fed.cohorts[0]
    cid = int(coh.client_ids[1])
    got = snap.params_for(cid)
    for k, p in coh.model.named_parameters():
        assert torch.equal(got[k], p[1].detach())


# --- serving parity with the evaluation forward ---------------------------

def test_parity_whole_shard_per_client(trained):
    eng, store, splits = trained
    qe = QueryEngine(store)
    for coh in eng.fed.cohorts:
        ref = eval_forward(coh, splits)
        for row, cid in enumerate(coh.client_ids):
            xs = np.asarray(splits[int(cid)].test_x)
            res = qe.serve([int(cid)] * len(xs), xs, t=10.0)
            np.testing.assert_allclose(res.logits, ref[row], atol=1e-5,
                                       rtol=0)
            np.testing.assert_array_equal(res.preds,
                                          np.argmax(res.logits, -1))


def test_parity_mixed_cross_cohort_batch(trained):
    eng, store, splits = trained
    qe = QueryEngine(store)
    refs = {int(c): eval_forward(coh, splits)[r]
            for coh in eng.fed.cohorts
            for r, c in enumerate(coh.client_ids)}
    cids, feats, want = [], [], []
    for cid in [0, 3, 5, 9, 19, 26, 27]:   # all three families, odd batch
        for k in range(2):
            cids.append(cid)
            feats.append(np.asarray(splits[cid].test_x)[k])
            want.append(refs[cid][k])
    res = qe.serve(cids, np.stack(feats), t=10.0)
    np.testing.assert_allclose(res.logits, np.stack(want), atol=1e-5,
                               rtol=0)
    assert all(b & (b - 1) == 0 for b in res.buckets)  # pow2 buckets
    # each row is the same forward the engine runs at that shape
    view = store.current().views[0]
    rows = torch.as_tensor(store.current().row_of[[0, 3]])
    xs = torch.from_numpy(np.stack([feats[0], feats[2]]))
    exact = T.serve_step(view.module, view.params, rows, xs).numpy()
    np.testing.assert_array_equal(res.logits[[0, 2]], exact)


def test_parity_single_request(trained):
    eng, store, splits = trained
    qe = QueryEngine(store)
    coh = eng.fed.cohorts[0]
    cid = int(coh.client_ids[1])
    ref = eval_forward(coh, splits)[1]
    res = qe.serve([cid], np.asarray(splits[cid].test_x)[:1], t=10.0)
    np.testing.assert_allclose(res.logits[0], ref[0], atol=1e-5, rtol=0)
    assert res.buckets == (1,)


def test_serve_validates_inputs(trained):
    _, store, splits = trained
    qe = QueryEngine(store)
    x = np.asarray(splits[0].test_x)[:1]
    with pytest.raises(ValueError, match="disagree on batch size"):
        qe.serve([0, 1], x, t=0.0)
    with pytest.raises(ValueError, match="out of range"):
        qe.serve([10_000], x, t=0.0)


def test_response_carries_version_and_staleness(trained):
    _, store, splits = trained
    qe = QueryEngine(store)
    snap = store.current()
    res = qe.serve([0], np.asarray(splits[0].test_x)[:1],
                   t=snap.published_at + 3.0)
    assert res.version == snap.version
    assert res.staleness == 3.0


def test_bucket_floor_and_max_bucket(trained):
    _, store, _ = trained
    x = np.zeros((10, 16), np.float32)
    assert QueryEngine(store, bucket_floor=8).serve(
        [0, 3, 6], x[:3], t=0.0).buckets == (8,)      # one cohort
    res = QueryEngine(store, max_bucket=4).serve(
        [3 * i for i in range(10)], x, t=0.0)   # one cohort, 10 rows
    assert res.buckets == (4, 4, 2) and res.n == 10


def test_query_engine_ctor_validation(trained):
    _, store, _ = trained
    with pytest.raises(ValueError):
        QueryEngine(store, bucket_floor=0)
    with pytest.raises(ValueError):
        QueryEngine(store, bucket_floor=8, max_bucket=4)


# --- the queue and the batch policies (host code, as the reference's) -----

def reqs(n, t, start_seq=0):
    return [QueryRequest(client_id=i % 3, x=np.zeros(4, np.float32),
                         t_arrival=t, seq=start_seq + i)
            for i in range(n)]


def test_bucket_size_pow2():
    assert [bucket_size(n) for n in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 16]
    assert bucket_size(3, floor=8) == 8
    with pytest.raises(ValueError):
        bucket_size(0)


def test_policy_registry_and_coercions():
    assert T.registered_batch_policies() == J.registered_batch_policies()
    assert T.get_batch_policy("micro") is MicroBatch
    with pytest.raises(KeyError, match="unknown batch policy"):
        T.get_batch_policy("nope")
    assert isinstance(T.as_batch_policy(None), MicroBatch)
    assert T.as_batch_policy("micro:16").max_batch == 16
    inst = Immediate(max_batch=4)
    assert T.as_batch_policy(inst) is inst
    assert T.as_batch_policy("immediate").max_wait == 0.0
    with pytest.raises(ValueError):
        MicroBatch(max_batch=0)
    with pytest.raises(ValueError):
        MicroBatch(max_wait=-1.0)
    with pytest.raises(ValueError, match="already registered"):
        T.register_batch_policy("micro")(type("Dup", (T.BatchPolicy,), {}))


def test_queue_semantics():
    q = MicroBatchQueue(MicroBatch(max_batch=8, max_wait=0.25))
    assert q.push(reqs(3, t=1.0), t=1.0) == 1.25  # oldest + max_wait
    assert q.pop_due(1.1) == []
    assert [len(b) for b in q.pop_due(1.25)] == [3] and q.depth == 0
    q = MicroBatchQueue(MicroBatch(max_batch=4, max_wait=0.25))
    assert q.push(reqs(4, t=2.0), t=2.0) == 2.0   # full: due now
    assert len(q.pop_due(2.0)) == 1
    q.push(reqs(10, t=3.0), t=3.0)
    batches = q.pop_due(3.0)
    assert [len(b) for b in batches] == [4, 4] and q.depth == 2
    tail = q.pop_due(3.25)
    assert [len(b) for b in tail] == [2]
    assert q.n_released == q.n_pushed == 14      # nothing dropped
    served = [r.seq for bs in (batches + tail) for r in bs]
    assert served == sorted(served)              # FIFO
    q = MicroBatchQueue(Immediate(max_batch=64))
    assert q.push(reqs(2, t=3.0), t=3.0) == 3.0
    assert q.push([], t=4.0) is None
    q = MicroBatchQueue(MicroBatch(max_batch=8, max_wait=0.5))
    assert q.next_deadline() is None
    q.push(reqs(2, t=1.0), t=1.0)
    q.push(reqs(2, t=1.3, start_seq=2), t=1.3)
    assert q.next_deadline() == 1.5              # the oldest rules


def test_queue_replays_the_reference_queue():
    """A random push/pop schedule gives the reference's deadlines and
    batches, request for request."""
    rng = np.random.default_rng(0)
    ops = [(float(t), int(rng.integers(0, 9)))
           for t in np.round(np.cumsum(rng.exponential(0.1, 200)), 3)]

    def replay(mod, policy):
        q, seq, out = mod.MicroBatchQueue(policy), 0, []
        for t, n in ops:
            batch = [mod.QueryRequest(client_id=seq % 5, x=None,
                                      t_arrival=t, seq=seq + i)
                     for i in range(n)]
            seq += n
            out.append((q.push(batch, t), q.next_deadline(),
                        [[r.seq for r in b] for b in q.pop_due(t)]))
        return out, q.n_pushed, q.n_released, q.max_depth

    for spec in ("micro:4", "micro:16", "immediate:3"):
        assert replay(T, T.as_batch_policy(spec)) == \
            replay(J, J.as_batch_policy(spec)), spec


# --- query workloads -------------------------------------------------------

WORKLOADS = {
    "poisson": dict(rate=0.8, seed=4),
    "poisson-slow": dict(rate=0.2, seed=0),
    "diurnal": dict(base_rate=0.4, amp=0.8, period=8.0, seed=1),
    "diurnal-burst": dict(base_rate=0.3, period=6.0, burst_frac=0.5,
                          seed=2),
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_workload_wakes_equal_the_reference(name):
    kind = "Poisson" if name.startswith("poisson") else "Diurnal"
    got = getattr(T, f"{kind}Queries")(**WORKLOADS[name]).wakes(11, 20.0)
    want = getattr(J, f"{kind}Queries")(**WORKLOADS[name]).wakes(11, 20.0)
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert repr(getattr(T, f"{kind}Queries")(**WORKLOADS[name])) == \
        repr(getattr(J, f"{kind}Queries")(**WORKLOADS[name]))


def test_poisson_deterministic_sorted_and_rate_scaled():
    a = PoissonQueries(rate=0.8, seed=4).wakes(6, 10.0)
    b = PoissonQueries(rate=0.8, seed=4).wakes(6, 10.0)
    assert [t for t, _ in a] == [t for t, _ in b]
    times = [t for t, _ in a]
    assert times == sorted(times) and times[-1] <= 10.0
    assert all(m.any() for _, m in a)
    lo = sum(m.sum() for _, m in PoissonQueries(rate=0.2).wakes(8, 20.0))
    hi = sum(m.sum() for _, m in PoissonQueries(rate=1.5).wakes(8, 20.0))
    assert hi > lo * 2


def test_query_workloads_registered():
    assert isinstance(get_arrivals("query-poisson")(), PoissonQueries)
    assert isinstance(get_arrivals("query-diurnal")(), DiurnalQueries)


def test_diurnal_burst_crests():
    w = DiurnalQueries(base_rate=0.3, period=8.0, burst_frac=1.0, seed=1)
    wakes = dict(w.wakes(10, 20.0))
    for peak in (2.0, 10.0, 18.0):       # period/4 + k*period
        assert wakes[peak].all()
    no_burst = DiurnalQueries(base_rate=0.3, period=8.0, seed=1)
    assert sum(m.sum() for _, m in w.wakes(10, 20.0)) > \
        sum(m.sum() for _, m in no_burst.wakes(10, 20.0))


def test_workload_arg_validation():
    with pytest.raises(ValueError):
        PoissonQueries(rate=0.0)
    with pytest.raises(ValueError):
        DiurnalQueries(amp=1.5)
    with pytest.raises(ValueError):
        DiurnalQueries(burst_frac=-0.1)


def test_split_query_stream_replays_test_samples(setup_small):
    _, splits, _, _ = setup_small
    feats = split_query_stream(splits)
    xs = np.asarray(splits[2].test_x)
    np.testing.assert_array_equal(feats(2, 0), xs[0])
    np.testing.assert_array_equal(feats(2, len(xs)), xs[0])  # wraps


# --- QueryRuntime: train-and-serve on one event loop ----------------------

@pytest.fixture()
def async_eng(setup_small):
    ds, splits, zoo, assignment = setup_small
    eng = AsyncFederationEngine.build(
        ds, splits, zoo, assignment, sqmd(q=8, k=4), arrivals="cadence",
        trigger="every-k", config=FederationConfig(**CFG), seed=5,
        device="cpu")
    return eng, splits


def test_runtime_serves_while_training(async_eng):
    eng, splits = async_eng
    qr = QueryRuntime(eng, workload=PoissonQueries(rate=0.6, seed=2),
                      policy="micro:8", features=split_query_stream(splits))
    hist = qr.run(splits, until=4.0)
    s = qr.summary(horizon=4.0)
    assert s["n_served"] > 0 and len(hist.mean_acc) > 0
    assert s["snapshots_published"] > 1
    assert s["n_served"] + s["n_pending"] == s["n_pushed"]
    assert s["latency_p99_s"] >= s["latency_p50_s"] >= 0.0
    versions = [r["version"] for r in sorted(qr.records,
                                             key=lambda r: r["t_served"])]
    assert versions == sorted(versions) and len(set(versions)) > 1
    assert all(0.0 <= r["staleness"] < 4.0 for r in qr.records)


def test_runtime_record_parity_with_direct_forward(async_eng):
    """An answer from the runtime's snapshot is the forward of that
    snapshot's params for the client."""
    eng, splits = async_eng
    qr = QueryRuntime(eng, workload=PoissonQueries(rate=0.4, seed=1),
                      policy="micro:4", features=split_query_stream(splits))
    qr.run(splits, until=3.0)
    snap = qr.store.current()
    res = qr.qengine.serve([0, 0], np.asarray(splits[0].test_x)[:2],
                           t=3.0, snapshot=snap)
    view = snap.views[int(snap.view_of[0])]
    stacked = {k: v[None] for k, v in snap.params_for(0).items()}
    with torch.no_grad():
        ref = torch.func.functional_call(view.module, stacked, (
            torch.from_numpy(np.asarray(splits[0].test_x[:2]))[None],))[0]
    np.testing.assert_allclose(res.logits, ref.numpy(), atol=1e-5, rtol=0)


def test_runtime_requires_feature_source(async_eng):
    eng, _ = async_eng
    qr = QueryRuntime(eng, workload=PoissonQueries(rate=0.5))
    with pytest.raises(ValueError, match="no feature source"):
        qr.seed_queries(2.0)


def test_unknown_event_kind_raises(async_eng):
    eng, splits = async_eng
    eng.clock.schedule(0.5, "wormhole")
    with pytest.raises(ValueError, match="no handler .*wormhole"):
        eng.fit(splits, until=1.0)


# the same train-and-serve run in both packages: the federation of
# test_torch_async.build_both on a heterogeneous cadence, every 10 rows
SERVE_RUNS = {
    "poisson-micro8": (lambda m: m.PoissonQueries(rate=0.6, seed=2),
                       "micro:8"),
    "diurnal-burst-micro4": (
        lambda m: m.DiurnalQueries(base_rate=0.4, period=4.0,
                                   burst_frac=0.5, seed=3),
        lambda m: m.MicroBatch(max_batch=4, max_wait=0.25)),
}
RECORD_KEYS = ("seq", "client_id", "t_arrival", "t_served", "queue_wait_s",
               "pred", "version", "staleness", "batch_size", "buckets",
               "depth_at_admission")


def _serving(serve_mod, eng, splits, workload, policy, logits):
    qr = serve_mod.QueryRuntime(
        eng, workload=workload(serve_mod),
        policy=policy if isinstance(policy, str) else policy(serve_mod),
        features=serve_mod.split_query_stream(splits))
    serve = qr.qengine.serve

    def keeping(*a, **kw):
        res = serve(*a, **kw)
        logits.append(np.asarray(res.logits))
        return res

    qr.qengine.serve = keeping
    return qr


@pytest.fixture(scope="module", params=list(SERVE_RUNS))
def served(request):
    workload, policy = SERVE_RUNS[request.param]
    r = build_both(_sqmd,
                   arrivals=lambda m: m.HeterogeneousCadence(
                       fast=1.0, slow=2.5, seed=4),
                   trigger=lambda m: m.EveryKUploads(k=10))
    jlog, tlog = [], []
    jqr = _serving(J, r["jeng"], r["splits"], workload, policy, jlog)
    tqr = _serving(T, r["teng"], r["psplits"], workload, policy, tlog)
    jqr.run(r["splits"], until=4.0)
    tqr.run(r["psplits"], until=4.0)
    return dict(r, jqr=jqr, tqr=tqr, jlog=jlog, tlog=tlog)


def test_runtime_records_equal_the_reference(served):
    jqr, tqr = served["jqr"], served["tqr"]
    assert len(tqr.records) == len(jqr.records) > 20
    assert len({r["version"] for r in tqr.records}) > 1
    assert max(r["batch_size"] for r in tqr.records) > 1
    for t, j in zip(tqr.records, jqr.records):
        for key in RECORD_KEYS:
            if key != "pred":
                assert t[key] == j[key], key
    assert tqr.store.n_published == jqr.store.n_published
    ts, js = tqr.summary(4.0), jqr.summary(4.0)
    for key in ("n_served", "queue_wait_p99_s", "mean_batch",
                "queue_depth_mean", "queue_depth_max", "staleness_mean",
                "staleness_max", "versions_served", "throughput_virtual_qps",
                "policy", "workload", "n_pushed", "n_pending",
                "queue_max_depth", "snapshots_published"):
        assert ts[key] == js[key], key


def test_runtime_logits_within_tolerance(served):
    """Served logits agree within LOGIT_TOL; a prediction may differ only
    where the reference's top two logits lie within 2 * LOGIT_TOL."""
    assert len(served["tlog"]) == len(served["jlog"])
    for t, j in zip(served["tlog"], served["jlog"]):
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, rtol=0)
    preds_t = np.array([r["pred"] for r in served["tqr"].records])
    preds_j = np.array([r["pred"] for r in served["jqr"].records])
    served_j = np.concatenate(served["jlog"])
    top2 = np.sort(served_j, -1)[:, -2:]
    flips = preds_t != preds_j
    assert (top2[:, 1] - top2[:, 0])[flips].max(initial=0.0) \
        < 2 * LOGIT_TOL


# --- the launch CLI --------------------------------------------------------

CLI = ["--until", "3", "--samples-per-client", "16", "--ref-size", "16",
       "--eval-every", "2", "--query-arrivals", "query-diurnal",
       "--query-rate", "0.5", "--burst-frac", "0.5", "--batch-policy",
       "micro", "--max-batch", "8"]


def test_serve_federation_cli_matches_reference(monkeypatch, tmp_path):
    out = tmp_path / "ref.json"
    monkeypatch.setattr(sys, "argv", ["serve_federation", *CLI,
                                      "--json", str(out)])
    jserve_federation.main()
    want = json.loads(out.read_text())
    got = serve_federation.main(["--device", "cpu", *CLI,
                                 "--json", str(tmp_path / "port.json")])
    assert json.loads((tmp_path / "port.json").read_text()) == got
    for key in ("policy", "dataset", "until", "clients", "server_rounds",
                "train_staleness"):
        assert got[key] == want[key], key
    timing = ("latency_p50_s", "latency_p99_s", "latency_mean_s",
              "compute_wall_s", "throughput_compute_qps")
    assert set(got["serving"]) == set(want["serving"])
    for key, value in want["serving"].items():
        if key not in timing:
            assert got["serving"][key] == value, key
    assert got["serving"]["n_served"] > 0 and np.isfinite(got["final_acc"])
    assert got["device"] == "cpu"
