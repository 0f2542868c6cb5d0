"""The port's tracer (``repro_torch.trace``) on a tiny CPU federation:
off, it hands back one shared no-op and reads no clock; a recording
holds the span tree of a round and its host syncs by site; under
``torch.profiler`` the spans are ranges nested under ``round``; and a
round is bit for bit the same with tracing on or off."""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch import trace
from repro_torch.data import make_splits, pad_like
from repro_torch.kernels import ops
from repro_torch.models import zoo as TZ

BATCH = 4
FAMILIES = ("mlp-s", "resnet", "transformer")
CLIENT = {"client.batch", "client.forward", "client.backward",
          "client.optimizer"}
# each site's syncs in one round of the engine below, every client awake
SITES = {"client.mask": 1, "client.rows": 3, "client.batch_indices": 3,
         "upload.ids": 3, "upload.mask": 1, "upload.rows": 1,
         "server.candidates": 1, "server.pool": 1,
         "server.receivers_all": 1, "server.receivers": 1,
         "server.staleness": 1}
PARENT = {"client.step": "round", "upload.collect": "round",
          "upload.merge": "round", "server.fire": "round",
          **{n: "client.step" for n in CLIENT},
          "upload.messengers": "upload.collect",
          "upload.assemble": "upload.collect",
          **{n: "server.fire" for n in ("server.grade", "server.graph",
                                         "server.targets", "server.downlink",
                                         "server.staleness")},
          "sync.client.mask": "client.step",
          "sync.client.rows": "client.batch",
          "sync.client.batch_indices": "client.batch",
          "sync.upload.ids": "upload.assemble",
          "sync.upload.mask": "upload.merge",
          "sync.upload.rows": "upload.merge",
          "sync.server.candidates": "server.graph",
          "sync.server.pool": "server.graph",
          "sync.server.receivers_all": "server.downlink",
          "sync.server.receivers": "server.downlink",
          "sync.server.staleness": "server.staleness"}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def engine(kind: str = "sync"):
    """Three families over 6 clients, batch draws through the seam."""
    ds = pad_like(samples_per_client=12, ref_size=9, length=16)
    splits = make_splits(ds, seed=0)
    zoo = TZ.build_zoo(",".join(FAMILIES), ds.feature_len, ds.n_classes)
    made = {}

    def draws(step, ci):
        coh = made["engine"].fed.cohorts[ci]
        m = coh.shards[0].data["y"].shape[1]
        return np.random.default_rng(100 * step + ci).integers(
            0, m, (coh.n_clients, BATCH))

    common = dict(config=T.FederationConfig(rounds=2, batch_size=BATCH),
                  seed=3, device="cpu", batch_indices=draws)
    if kind == "sync":
        eng = T.FederationEngine.build(ds, splits, zoo, None,
                                       T.sqmd(q=4, k=2), **common)
    else:
        eng = T.AsyncFederationEngine.build(ds, splits, zoo, None,
                                            T.sqmd(q=4, k=2), **common)
    made["engine"] = eng
    return eng, splits


def test_off_is_one_shared_noop_that_reads_no_clock(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the tracer worked while off")

    assert trace.span("round", round=1) is trace.span("client.step") \
        is trace.sync("client.mask")
    monkeypatch.setattr(trace, "_clock", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    eng, _ = engine()
    eng.run_round(0)
    eng.run_round(1)
    assert trace._active is None
    with pytest.raises(AssertionError):
        with trace.recording():
            eng.run_round(2)


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_recording_holds_the_round_tree_and_its_syncs(kind):
    eng, splits = engine(kind)
    if kind == "sync":
        eng.run_round(0)
        with trace.recording() as rec:
            eng.run_round(1)
    else:
        with trace.recording() as rec:
            eng.fit(splits, until=1.0)
    spans = rec.spans
    names = [s.name for s in spans]
    for s in spans:
        assert s.end_ns >= s.start_ns
        # the async engine's layers and its evals' staleness stand alone
        if s.name in PARENT and (kind == "sync" or s.parent is not None):
            assert spans[s.parent].name == PARENT[s.name], s
    per_cohort = {f: {s.name for s in spans if s.name in CLIENT
                      and s.attrs.get("cohort") == f} for f in FAMILIES}
    assert all(v == CLIENT for v in per_cohort.values()), per_cohort
    uploads = [s.attrs["cohort"] for s in spans
               if s.name == "upload.messengers"]
    assert sorted(set(uploads)) == sorted(FAMILIES)
    if kind == "sync":
        assert spans[0].name == "round" and spans[0].parent is None
        assert {s.round for s in spans} == {1}
        assert rec.host_syncs() == SITES
        # self times add up to the round's
        top = rec.names["round"]["total_s"]
        assert sum(n["self_s"] for n in rec.names.values()) == \
            pytest.approx(top, rel=1e-9)
    else:
        assert "round" not in names and {s.round for s in spans} == {None}
        assert set(rec.host_syncs()) == set(SITES)
    for n in rec.names.values():
        assert 0 <= n["self_s"] <= n["total_s"]


def test_recording_counts_kernel_launches_and_does_not_nest():
    with trace.recording() as rec:
        ops._pk.launches += 2
        with pytest.raises(RuntimeError, match="do not nest"):
            with trace.recording():
                pass
    assert rec.counters == {"kernels.pairwise_kl_pair": 2}
    assert rec.spans == [] and rec.names == {}


def test_spans_are_profiler_ranges_under_round():
    from torch.profiler import ProfilerActivity, profile
    eng, _ = engine()
    eng.run_round(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run_round(1)
    events = prof.events()
    rounds = [e for e in events if e.name == "round"]
    assert len(rounds) == 1
    lo, hi = rounds[0].time_range.start, rounds[0].time_range.end
    want = set(PARENT) - {"round"}
    found = {e.name for e in events if e.name in want
             and lo <= e.time_range.start <= e.time_range.end <= hi}
    assert found == want


@pytest.mark.parametrize("mode", ["recording", "profiler"])
def test_a_traced_round_is_bit_identical(mode):
    from torch.profiler import ProfilerActivity, profile

    def state(eng):
        fed = eng.fed
        params = [p.detach().clone() for coh in fed.cohorts
                  for p in coh.model.parameters()]
        return params + [fed.server.repo_logp.clone(), fed.targets.clone()]

    plain, traced = engine()[0], engine()[0]
    for rnd in range(2):
        plain.run_round(rnd)
        on = trace.recording() if mode == "recording" else profile(
            activities=[ProfilerActivity.CPU])
        with on:
            traced.run_round(rnd)
    for a, b in zip(state(plain), state(traced)):
        assert torch.equal(a, b)
