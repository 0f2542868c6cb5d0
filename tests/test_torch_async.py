"""The port's asynchronous federation, and its sync engine under the
``dropout``, ``straggler`` and ``staged-join`` schedules with several local
steps a wake, end to end against live runs of the reference's.

The fixture is tests/test_torch_engine.py's: pad_like(30, 30, 24), splits
seed 0, batch 8, eval_every 2, seed 7, the reference on kernel backend
``jnp``. Its initial params go into the port through ``init_params``; its
threefry batch draws (one split per cohort per inner step per wake, in
build order) through ``batch_indices``, keyed by inner step. Arrival
processes, schedules and triggers draw only numpy, so both packages see
the same wakes, latencies and fires.

Asserted: the History bookkeeping (rounds, times, server rounds,
staleness, wire bytes) exactly; eval logits within LOGIT_TOL; every fire
choosing the same edges as the reference's, up to near ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.data import make_splits as jax_make_splits
from repro.data import pad_like as jax_pad_like
from repro.models.mlp import hetero_mlp_zoo as jax_zoo
from repro_torch.data import make_splits, pad_like
from repro_torch.examples.async_join import join_rows, staleness_rows
from repro_torch.models import hetero_mlp_zoo
from test_torch_engine import LOGIT_TOL, _record_fires, _stack_test

CFG = dict(rounds=4, batch_size=8, eval_every=2)
SEED = 7


def _lazy_draws(jeng, batch_size):
    """The reference's batch draws, made on demand from its initial key:
    inner step s, cohort ci -> (n_c, B) indices."""
    shapes = [tuple(coh.data["y"].shape) for coh in jeng.fed.cohorts]
    key, cache = [jeng.fed.rng], {}

    def get(step, ci):
        while (step, ci) not in cache:
            s = len(cache) // len(shapes)
            for cj, (n_c, m) in enumerate(shapes):
                key[0], sub = jax.random.split(key[0])
                cache[s, cj] = np.asarray(
                    jax.random.randint(sub, (n_c, batch_size), 0, m))
        return cache[step, ci]

    return get


def _logit_recorder(splits, n, n_classes, out, port):
    def cb(engine, rnd, metrics):
        got = np.zeros((n, len(splits[0].test_y), n_classes))
        for coh in engine.fed.cohorts:
            xs, _ = _stack_test(splits, coh.client_ids)
            if port:
                with torch.no_grad():
                    got[coh.client_ids] = coh.model(
                        torch.from_numpy(xs)).numpy()
            else:
                got[coh.client_ids] = np.asarray(
                    jax.vmap(coh.apply_fn)(coh.params, jnp.asarray(xs)))
        out.append(got)
    return cb


def _hold_payloads(eng):
    """Fail if an upload's payload changed between its wake and its
    delivery (a view of a parameter, an in-place encode or assemble)."""
    kept, deliveries = {}, []
    collect, deliver = eng.clients.collect_messengers, eng.bus.deliver

    def collecting(mask):
        msg = collect(mask)
        kept[id(msg)] = {k: a.clone() for k, a in msg.arrays.items()}
        return msg

    def delivering(t, msg, uploaded, produced_at=None):
        for k, a in kept[id(msg)].items():
            assert torch.equal(msg.arrays[k], a), "an in-flight upload moved"
        deliveries.append(int(np.sum(uploaded)))
        return deliver(t, msg, uploaded, produced_at=produced_at)

    eng.clients.collect_messengers = collecting
    eng.bus.deliver = delivering
    return deliveries


def run_both(protocol, *, arrivals=None, trigger=None, schedule=None,
             horizons=(4.0,), **config):
    """One federation in both packages (``build_both``). With ``schedule``
    the sync engine runs ``CFG['rounds']`` rounds; otherwise the async
    engine runs ``fit(until=h)`` for each horizon in turn."""
    r = build_both(protocol, arrivals=arrivals, trigger=trigger,
                   schedule=schedule, **config)
    jeng, teng = r["jeng"], r["teng"]
    if schedule is not None:
        r["jhist"], r["thist"] = jeng.fit(r["splits"]), teng.fit(r["psplits"])
    else:
        for h in horizons:
            r["jhist"] = jeng.fit(r["splits"], until=h)
        for h in horizons:
            r["thist"] = teng.fit(r["psplits"], until=h)
    return r


def build_both(protocol, *, arrivals=None, trigger=None, schedule=None,
               **config):
    """One federation built in both packages, the port's with the
    reference's initial params and batch draws. ``protocol``,
    ``arrivals``, ``trigger`` and ``schedule`` are functions of the
    package's core module (``repro.core`` or ``repro_torch.core``), so
    each side builds its own objects from the same arguments; with
    ``schedule`` the engines are the sync ones."""
    cfg = {**CFG, **config}
    sync = schedule is not None
    ds = jax_pad_like(samples_per_client=30, ref_size=30, length=24)
    splits = jax_make_splits(ds, seed=0)
    zoo = jax_zoo(ds.feature_len, ds.n_classes)
    assignment = [list(zoo)[i % 3] for i in range(ds.n_clients)]
    jlogits, tlogits, jfires, tfires = [], [], [], []
    jcb = _logit_recorder(splits, ds.n_clients, ds.n_classes, jlogits,
                          port=False)
    if sync:
        jeng = J.FederationEngine.build(
            ds, splits, zoo, assignment, protocol(J),
            config=J.FederationConfig(**cfg, backend="jnp"),
            schedule=schedule(J), seed=SEED, callbacks=[jcb])
    else:
        jeng = J.AsyncFederationEngine.build(
            ds, splits, zoo, assignment, protocol(J),
            arrivals=arrivals(J), trigger=trigger and trigger(J),
            config=J.FederationConfig(**cfg, backend="jnp"), seed=SEED,
            callbacks=[jcb])
    _record_fires(jeng.bus, jfires)
    jpublished, tpublished = [], []
    jeng.publish_hooks.append(jpublished.append)
    init_params = {coh.family_name: jax.tree.map(np.asarray, coh.params)
                   for coh in jeng.fed.cohorts}
    draws = _lazy_draws(jeng, cfg["batch_size"])

    pds = pad_like(samples_per_client=30, ref_size=30, length=24)
    psplits = make_splits(pds, seed=0)
    tcb = _logit_recorder(psplits, pds.n_clients, pds.n_classes, tlogits,
                          port=True)
    common = dict(config=T.FederationConfig(**cfg), seed=SEED,
                  callbacks=[tcb], device="cpu", init_params=init_params,
                  batch_indices=draws)
    tzoo = hetero_mlp_zoo(pds.feature_len, pds.n_classes)
    if sync:
        teng = T.FederationEngine.build(pds, psplits, tzoo, assignment,
                                        protocol(T), schedule=schedule(T),
                                        **common)
    else:
        teng = T.AsyncFederationEngine.build(
            pds, psplits, tzoo, assignment, protocol(T),
            arrivals=arrivals(T), trigger=trigger and trigger(T), **common)
    _record_fires(teng.bus, tfires)
    teng.publish_hooks.append(tpublished.append)
    deliveries = _hold_payloads(teng)
    return dict(jeng=jeng, teng=teng, splits=splits, psplits=psplits,
                init_params=init_params, draws=draws, jlogits=jlogits,
                tlogits=tlogits, jfires=jfires, tfires=tfires,
                deliveries=deliveries, jpublished=jpublished,
                tpublished=tpublished)


def assert_same_edges(jf, tf):
    """Per fire, each client's neighbor set equals the reference's, or the
    differing picks are near-ties: the sorted similarities of the two
    sets agree to 1e-4 relative. A graph without slot weights (FedMD's
    complete graph) must carry the same dense W."""
    assert len(jf) == len(tf)
    for jg, tg in zip(jf, tf):
        jw, tw = np.asarray(jg.weights), tg.weights.numpy()
        if tg.slot_weights is None:
            np.testing.assert_allclose(tw, jw, atol=1e-7, rtol=1e-6)
            continue
        np.testing.assert_array_equal(tg.candidates.numpy(),
                                      np.asarray(jg.candidates))
        jsim, tsim = np.asarray(jg.similarity), tg.similarity.numpy()
        for i in range(jw.shape[0]):
            je, te = np.nonzero(jw[i])[0], np.nonzero(tw[i])[0]
            if np.array_equal(je, te):
                continue
            np.testing.assert_allclose(np.sort(tsim[i, te]),
                                       np.sort(jsim[i, je]), rtol=1e-4)


def assert_parity(r):
    jh, th = r["jhist"], r["thist"]
    assert th.rounds == jh.rounds and th.times == jh.times
    assert th.server_rounds == jh.server_rounds
    assert th.staleness == jh.staleness
    assert th.bytes_up == jh.bytes_up and th.bytes_down == jh.bytes_down
    assert len(th.mean_acc) == len(jh.mean_acc) >= 2
    assert len(r["tlogits"]) == len(r["jlogits"]) == len(jh.rounds)
    for t, j in zip(r["tlogits"], r["jlogits"]):
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, rtol=0)
    assert_same_edges(r["jfires"], r["tfires"])
    # publish hooks run at the same instants: every round or wake, and
    # every fire
    assert r["tpublished"] == r["jpublished"] and r["tpublished"]
    js, ts = r["jeng"].server, r["teng"].server
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    jr, tr = np.asarray(js.repo_logp), ts.repo_logp.numpy()
    tol = LOGIT_TOL
    if r["teng"].fed.uplink == "int8":
        # messengers within LOGIT_TOL of each other may round to
        # neighboring uint8 codes: one step of the row's scale apart
        tol = LOGIT_TOL + (jr.max(-1, keepdims=True)
                           - jr.min(-1, keepdims=True)) / 255
    assert (np.abs(tr - jr) <= tol).all()
    assert int(ts.round) == int(js.round)
    jb, tb = r["jeng"].bus, r["teng"].bus
    assert tb.n_uploads == jb.n_uploads and tb.n_triggers == jb.n_triggers
    np.testing.assert_array_equal(tb.last_upload_t, jb.last_upload_t)


def _sqmd(m):
    return m.sqmd(q=8, k=4)


def _join(n, stages):
    return [stages[i % len(stages)] for i in range(n)]


N_FIX = 28   # pad_like's client count

RUNS = {
    # fig. 4 regime A: staged facilities through the schedule shim; no
    # client has joined at t=0, so the first wake is all-False
    "staged-sqmd-empty-first-wake": dict(
        protocol=_sqmd,
        arrivals=lambda m: m.ScheduleArrivals(
            m.StagedJoin(_join(N_FIX, [1, 2, 3])))),
    "staged-fedmd": dict(
        protocol=lambda m: m.fedmd(),
        arrivals=lambda m: m.ScheduleArrivals(
            m.StagedJoin(_join(N_FIX, [0, 2])))),
    # regime B: delayed uploads merge stale on a quorum, delta rounds
    "straggler-quorum-delta": dict(
        protocol=_sqmd,
        arrivals=lambda m: m.StragglerLatency(fraction=0.3, delay=2.5,
                                              seed=1),
        trigger=lambda m: m.Quorum(frac=0.5), delta_graph=True),
    # one upload event per client, fires every k rows, on the IVF index
    # and the int8 uplink
    "bursty-every-k-ivf-int8": dict(
        protocol=_sqmd,
        arrivals=lambda m: m.BurstyArrivals(burst_every=2.0, frac=0.5,
                                            jitter=0.8, seed=2),
        trigger=lambda m: m.EveryKUploads(k=6), delta_graph=True,
        selection="ivf", uplink="int8"),
    # wall-clock fires on a heterogeneous cadence, fit resumed
    "interval-cadence-resumed": dict(
        protocol=_sqmd,
        arrivals=lambda m: m.HeterogeneousCadence(fast=1.0, slow=2.5,
                                                  seed=4),
        trigger=lambda m: m.WallInterval(period=1.5), horizons=(2.0, 4.5)),
    "isgd-bursty": dict(
        protocol=lambda m: m.isgd(),
        arrivals=lambda m: m.BurstyArrivals(burst_every=1.0, frac=0.5,
                                            seed=5)),
    "local-steps-2": dict(
        protocol=_sqmd,
        arrivals=lambda m: m.StragglerLatency(fraction=0.5, delay=1.0,
                                              seed=3),
        trigger=lambda m: m.EveryKUploads(k=10), local_steps=2),
    # the sync engine: none of these schedules was pinned before
    "sync-dropout-local-steps-2": dict(
        protocol=_sqmd,
        schedule=lambda m: m.RandomDropout(p=0.3, seed=2), local_steps=2),
    "sync-straggler-local-steps-2": dict(
        protocol=_sqmd,
        schedule=lambda m: m.Straggler(fraction=0.4, period=2, seed=1),
        local_steps=2),
    "sync-staged-join": dict(
        protocol=_sqmd, schedule=lambda m: m.StagedJoin(_join(N_FIX,
                                                              [0, 1, 3]))),
}


@pytest.fixture(scope="module", params=list(RUNS))
def runs(request):
    out = run_both(**RUNS[request.param])
    out["name"] = request.param
    return out


def test_federation_matches_reference(runs):
    assert_parity(runs)


def test_run_exercises_its_regime(runs):
    """Each run reaches the case it is there for."""
    name, jh, teng = runs["name"], runs["jhist"], runs["teng"]
    bus, deliveries = teng.bus, runs["deliveries"]
    if name == "staged-sqmd-empty-first-wake":
        # the all-False wake at t=0 still fired an (empty) server round
        assert deliveries[0] == 0 and jh.server_rounds[0] == 1
        # 10, 19, 28 and 28 joined clients upload at t = 1..4
        assert bus.n_uploads == 10 + 19 + 28 + 28
    if name == "straggler-quorum-delta":
        assert bus.delta and max(s["max"] for s in jh.staleness) >= 2.5
        # the slow 30 % land 2.5 later: two upload events a wake
        assert sorted(set(deliveries)) == [8, 20]
    if name == "bursty-every-k-ivf-int8":
        # every client's upload is its own event
        assert set(deliveries) == {1} and bus.n_uploads == len(deliveries)
        assert teng.policy._ivf is not None
    if name == "interval-cadence-resumed":
        assert jh.times == [0.0, 2.0, 4.0, 4.5] and bus.n_triggers == 3
    if name == "isgd-bursty":
        assert not deliveries and bus.n_triggers == 0
        assert jh.bytes_up[-1] == 0.0
    if name in ("local-steps-2", "sync-dropout-local-steps-2",
                "sync-straggler-local-steps-2"):
        assert teng.clients.step == 2 * (5 if name == "local-steps-2"
                                         else CFG["rounds"])


def _acc_bound(tlogits, jlogits, n_test, clients):
    """How far an accuracy averaged over ``clients`` may move when
    predictions flip only at the near ties assert_parity allows: the
    most flips any of them has, over the test shard's size."""
    flips = (tlogits.argmax(-1) != jlogits.argmax(-1)).sum(-1)
    return flips[clients].max(initial=0) / n_test + 1e-12


def test_async_join_rows_match_reference(runs):
    """async_join's report rows read off both Histories: times, server
    rounds, candidates and staleness exactly; the overall and M1-only
    accuracies up to the near-tie flips of the eval logits."""
    jh, th = runs["jhist"], runs["thist"]
    m1 = np.arange(N_FIX) % 3 == 0
    n_test = len(runs["splits"][0].test_y)
    everyone = np.ones(N_FIX, bool)
    for t, j, tl, jl in zip(join_rows(th, m1), join_rows(jh, m1),
                            runs["tlogits"], runs["jlogits"]):
        assert (t[0], t[3], t[4]) == (j[0], j[3], j[4])
        assert abs(t[1] - j[1]) <= _acc_bound(tl, jl, n_test, everyone)
        assert abs(t[2] - j[2]) <= _acc_bound(tl, jl, n_test, m1)
    for t, j in zip(staleness_rows(th), staleness_rows(jh)):
        assert (t[0], *t[2:]) == (j[0], *j[2:])
    assert len(join_rows(th, m1)) == len(staleness_rows(jh)) \
        == len(jh.times)


def test_async_rejects_the_round_interval():
    ds = pad_like(samples_per_client=10, ref_size=6, length=8)
    splits = make_splits(ds, seed=0)
    zoo = hetero_mlp_zoo(ds.feature_len, ds.n_classes)
    with pytest.raises(ValueError, match="Trigger"):
        T.AsyncFederationEngine.build(ds, splits, zoo, None,
                                      T.sqmd(q=4, k=2, interval=2),
                                      device="cpu")
    # a reference-free policy has no server cadence to misstate
    T.AsyncFederationEngine.build(ds, splits, zoo, None, T.isgd(),
                                  device="cpu")


def test_async_build_defaults_to_the_card():
    ds = pad_like(samples_per_client=10, ref_size=6, length=8)
    splits = make_splits(ds, seed=0)
    zoo = hetero_mlp_zoo(ds.feature_len, ds.n_classes)
    if torch.cuda.is_available():
        eng = T.AsyncFederationEngine.build(ds, splits, zoo, None,
                                            T.sqmd(q=4, k=2))
        assert eng.fed.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.AsyncFederationEngine.build(ds, splits, zoo, None,
                                      T.sqmd(q=4, k=2))


def test_async_handlers_take_other_event_kinds():
    """Event kinds the engine does not know go to ``handlers``, at their
    priority on the shared clock; an unhandled kind is an error."""
    ds = pad_like(samples_per_client=10, ref_size=6, length=8)
    splits = make_splits(ds, seed=0)
    eng = T.AsyncFederationEngine.build(
        ds, splits, hetero_mlp_zoo(ds.feature_len, ds.n_classes), None,
        T.sqmd(q=4, k=2), config=T.FederationConfig(**CFG), device="cpu")
    seen = []
    eng.handlers["query"] = lambda ev: seen.append(
        (ev.time, ev.payload, len(eng.history.times)))
    eng.clock.schedule(2.0, "query", "q")
    eng.fit(splits, until=2.0)
    # the eval at t=2 ran first (priority 3 < 4)
    assert seen == [(2.0, "q", 2)]
    eng.clock.schedule(3.0, "no-such-kind")
    with pytest.raises(ValueError, match="no handler"):
        eng.fit(splits, until=3.0)


def test_async_fit_smaller_horizon_replays_nothing():
    ds = pad_like(samples_per_client=10, ref_size=6, length=8)
    splits = make_splits(ds, seed=0)
    zoo = hetero_mlp_zoo(ds.feature_len, ds.n_classes)
    eng = T.AsyncFederationEngine.build(
        ds, splits, zoo, None, T.sqmd(q=4, k=2),
        arrivals=T.BurstyArrivals(burst_every=2.0, frac=0.5, seed=2),
        config=T.FederationConfig(**CFG), device="cpu")
    eng.fit(splits, until=6.0)
    uploads, evals = eng.bus.n_uploads, len(eng.history.times)
    eng.fit(splits, until=2.0)
    assert eng.bus.n_uploads == uploads and len(eng.history.times) == evals
    h = eng.fit(splits, until=8.0)
    assert h.times == sorted(h.times) and h.times[-1] == 8.0
