"""The port's event runtime piece by piece, against live calls of the
reference's: schedules and arrival processes (the same masks, wake times,
latencies and joins at the same arguments), the registries and their
error texts, the Clock's order, the trigger predicates, the ServerBus
cases of tests/test_runtime.py run through both packages, History's
helpers, and the ``federate`` CLI's summary under ``--clock event`` and
``--schedule dropout --local-steps 2``.
"""
import json
import types

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.optim import sgd as jax_sgd
from repro_torch.launch import federate

N = 13


def _both(make):
    """``make`` applied to each package's core module."""
    return make(J), make(T)


def _join(n):
    return [(i * 7) % 4 for i in range(n)]


SCHEDULES = {
    "always-on": lambda m: m.AlwaysOn(),
    "staged-join": lambda m: m.StagedJoin(_join(N)),
    "dropout": lambda m: m.RandomDropout(p=0.4, seed=3),
    "dropout-over-staged": lambda m: m.RandomDropout(
        p=0.6, seed=1, base=m.StagedJoin(_join(N))),
    "straggler": lambda m: m.Straggler(fraction=0.4, period=3, seed=5),
    "straggler-over-staged": lambda m: m.Straggler(
        fraction=0.3, period=2, seed=2, base=m.StagedJoin(_join(N))),
}

ARRIVALS = {
    **{f"schedule:{k}": (lambda mk: lambda m: m.ScheduleArrivals(mk(m)))(v)
       for k, v in SCHEDULES.items()},
    "schedule-cadence": lambda m: m.ScheduleArrivals(
        m.StagedJoin(_join(N)), cadence=0.7),
    "straggler-latency": lambda m: m.StragglerLatency(fraction=0.4,
                                                      delay=2.5, seed=1),
    "straggler-latency-cadence": lambda m: m.StragglerLatency(
        fraction=0.3, delay=1.25, seed=4, cadence=0.5),
    "cadence": lambda m: m.HeterogeneousCadence(fast=0.7, slow=2.3,
                                                seed=3),
    "bursty": lambda m: m.BurstyArrivals(burst_every=1.5, frac=0.4,
                                         jitter=0.9, seed=6),
    "bursty-sparse": lambda m: m.BurstyArrivals(burst_every=2.0, frac=0.05,
                                                jitter=0.0, seed=1),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name):
    js, ts = _both(SCHEDULES[name])
    assert repr(ts) == repr(js) and ts.name == js.name
    for rnd in range(12):
        a, b = js.available(rnd, N), ts.available(rnd, N)
        assert b.dtype == bool
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(ts.joined(rnd, N), js.joined(rnd, N))


@pytest.mark.parametrize("name", list(ARRIVALS))
def test_arrivals_match_reference(name):
    ja, ta = _both(ARRIVALS[name])
    assert repr(ta) == repr(ja) and ta.name == ja.name
    jw, tw = ja.wakes(N, 7.3), ta.wakes(N, 7.3)
    assert [t for t, _ in tw] == [t for t, _ in jw]
    for (t, jm), (_, tm) in zip(jw, tw):
        assert tm.dtype == bool
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(ta.latency(t, tm, N),
                                      ja.latency(t, jm, N))
        jj, tj = ja.joined(t, N), ta.joined(t, N)
        assert (tj is None) == (jj is None)
        if jj is not None:
            np.testing.assert_array_equal(tj, jj)


def _core_names(names, get):
    """The registered names a package's ``core`` defines itself (each
    package's ``serve`` adds query arrival processes to the same registry
    when it is imported)."""
    return tuple(n for n in names if get(n).__module__.startswith(
        ("repro.core.", "repro_torch.core.")))


def test_registries_and_coercion_match_reference():
    assert T.registered_schedules() == _core_names(J.registered_schedules(),
                                                   J.get_schedule)
    assert _core_names(T.registered_arrivals(), T.get_arrivals) == \
        _core_names(J.registered_arrivals(), J.get_arrivals)
    assert T.registered_triggers() == _core_names(J.registered_triggers(),
                                                  J.get_trigger)
    for get, names in (("get_schedule", T.registered_schedules),
                       ("get_arrivals", T.registered_arrivals),
                       ("get_trigger", T.registered_triggers)):
        with pytest.raises(KeyError) as je:
            getattr(J, get)("nope")
        with pytest.raises(KeyError) as te:
            getattr(T, get)("nope")
        # the same text, over the names each registry holds
        assert str(te.value) == str(je.value).replace(
            str(getattr(J, names.__name__)()), str(names()))
    for name in T.registered_schedules():
        assert T.get_schedule(name).__name__ == J.get_schedule(name).__name__
    for name in _core_names(T.registered_arrivals(), T.get_arrivals):
        assert T.get_arrivals(name).__name__ == J.get_arrivals(name).__name__
    for name in T.registered_triggers():
        assert T.get_trigger(name).__name__ == J.get_trigger(name).__name__
    for arg in (None, "dropout", "straggler", "always-on"):
        assert repr(T.as_schedule(arg)) == repr(J.as_schedule(arg))
    assert repr(T.as_schedule(None, join_round=_join(N))) == \
        repr(J.as_schedule(None, join_round=_join(N)))
    sj = T.StagedJoin(_join(N))
    assert T.as_schedule(sj, join_round=[0] * N) is sj
    for arg in (None, "cadence", "bursty", "dropout", "straggler-latency"):
        assert repr(T.as_arrivals(arg)) == repr(J.as_arrivals(arg))
    assert isinstance(T.as_arrivals(sj), T.ScheduleArrivals)
    assert T.as_arrivals(sj).schedule is sj
    for arg in (None, "every-k", "quorum", "interval"):
        assert repr(T.as_trigger(arg)) == repr(J.as_trigger(arg))
    for reg in ("register_schedule", "register_arrivals", "register_trigger"):
        with pytest.raises(ValueError, match="already registered"):
            getattr(T, reg)({"register_schedule": "dropout",
                             "register_arrivals": "bursty",
                             "register_trigger": "quorum"}[reg])(object)


BAD_ARGS = [
    lambda m: m.RandomDropout(p=1.0), lambda m: m.Straggler(fraction=1.5),
    lambda m: m.Straggler(period=0), lambda m: m.ScheduleArrivals(cadence=0),
    lambda m: m.StragglerLatency(fraction=-0.1),
    lambda m: m.StragglerLatency(delay=-1.0),
    lambda m: m.StragglerLatency(cadence=0.0),
    lambda m: m.HeterogeneousCadence(fast=3.0, slow=1.0),
    lambda m: m.BurstyArrivals(burst_every=0.0),
    lambda m: m.BurstyArrivals(frac=0.0),
    lambda m: m.BurstyArrivals(jitter=-1.0),
    lambda m: m.EveryKUploads(k=0), lambda m: m.Quorum(count=0),
    lambda m: m.Quorum(frac=1.5), lambda m: m.WallInterval(period=0.0),
    lambda m: m.StagedJoin([0, 1]).available(0, 3),
    lambda m: m.FederationConfig(local_steps=0),
]


@pytest.mark.parametrize("i", range(len(BAD_ARGS)))
def test_validation_errors_match_reference(i):
    with pytest.raises(ValueError) as je:
        BAD_ARGS[i](J)
    with pytest.raises(ValueError) as te:
        BAD_ARGS[i](T)
    assert str(te.value) == str(je.value)


# --- Clock ----------------------------------------------------------------

def _clock_script(m):
    clk = m.Clock()
    log = []
    for t, kind, tag in [(2.0, "wake", "w2"), (1.0, "wake", "w1"),
                         (1.0, "eval", "e1"), (1.0, "upload", "u1"),
                         (1.0, "server-tick", "s1"), (1.0, "wake", "w1b"),
                         (1.0, "serve-flush", "f1"), (1.0, "query", "q1"),
                         (1.0, "custom", "c1"), (3.0, "upload", "u3")]:
        clk.schedule(t, kind, tag)
    log.append(len(clk))
    log.append(clk.peek_time())
    while (ev := clk.pop_due(2.0)) is not None:
        log.append((ev.time, ev.kind, ev.payload, clk.now))
    log.append(len(clk))
    with pytest.raises(ValueError) as e:
        clk.schedule(1.5, "wake")
    log.append(str(e.value))
    clk.advance(1.0)                    # never moves backward
    log.append(clk.now)
    clk.schedule(2.0 - 5e-10, "wake", "within-slack")
    log.append(clk.pop_due(10.0).payload)
    log.append(isinstance(m.SyncClock(), m.Clock))
    return log


def test_clock_order_and_rejection_match_reference():
    jlog, tlog = _both(_clock_script)
    assert tlog == jlog
    # ties break by kind priority, then FIFO
    assert [e[2] for e in tlog[2:11]] == ["u1", "s1", "w1", "w1b", "e1",
                                          "q1", "f1", "c1", "w2"]


# --- triggers -------------------------------------------------------------

def _stub(n, uploads, fresh):
    return types.SimpleNamespace(uploads_since_fire=uploads,
                                 fresh_since_fire=np.arange(n) < fresh,
                                 fed=types.SimpleNamespace(n_clients=n))


TRIGGERS = [lambda m: m.EveryUpload(), lambda m: m.EveryKUploads(k=5),
            lambda m: m.WallInterval(period=1.5), lambda m: m.Quorum(frac=0.5),
            lambda m: m.Quorum(count=3), lambda m: m.Quorum(frac=0.34),
            lambda m: m.as_trigger("every-k")]


@pytest.mark.parametrize("i", range(len(TRIGGERS)))
def test_trigger_predicates_match_reference(i):
    jt, tt = _both(TRIGGERS[i])
    assert repr(tt) == repr(jt) and tt.name == jt.name
    assert tt.wall_period() == jt.wall_period()
    for n in (1, 7, 10):
        for up in range(12):
            for fresh in range(n + 1):
                bus = _stub(n, up, fresh)
                assert tt.should_fire(0.5, bus) == jt.should_fire(0.5, bus)
                assert (tt.should_fire_on_tick(0.5, bus)
                        == jt.should_fire_on_tick(0.5, bus))


# --- ServerBus: the bus cases of tests/test_runtime.py, both packages ----

R, C, NB = 6, 3, 4


def _msg(seed):
    x = np.random.default_rng(seed).normal(size=(NB, R, C)) * 2.0
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _buses(trigger, delta=False):
    """A bus over a cohort-free federation in each package."""
    import jax.numpy as jnp
    from repro.core.policies import as_policy as jax_as_policy
    from repro_torch.core.policies import as_policy
    ref_y = (np.arange(R) % C).astype(np.int32)
    jfed = J.Federation(cohorts=[], server=J.init_server(NB, R, C),
                        protocol=J.sqmd(q=NB, k=2),
                        ref_x=jnp.zeros((R, 4)), ref_y=jnp.asarray(ref_y),
                        optimizer=jax_sgd(0.1), n_clients=NB)
    tfed = T.Federation(cohorts=[], server=T.init_server(NB, R, C, "cpu"),
                        ref_x=torch.zeros((R, 4)),
                        ref_y=torch.from_numpy(ref_y), n_clients=NB,
                        generator=torch.Generator())
    jb = J.ServerBus(jfed, jax_as_policy(J.sqmd(q=NB, k=2)),
                     trigger=trigger(J), backend="jnp", delta=delta)
    tb = T.ServerBus(tfed, as_policy(T.sqmd(q=NB, k=2)),
                     trigger=trigger(T), delta=delta)
    return jb, tb


def _rows(*ids):
    m = np.zeros(NB, bool)
    m[list(ids)] = True
    return m


def _assert_buses_equal(jb, tb, now):
    np.testing.assert_array_equal(tb.last_upload_t, jb.last_upload_t)
    assert tb.uploads_since_fire == jb.uploads_since_fire
    np.testing.assert_array_equal(tb.fresh_since_fire, jb.fresh_since_fire)
    assert (tb.n_uploads, tb.n_triggers) == (jb.n_uploads, jb.n_triggers)
    np.testing.assert_array_equal(tb.bytes_up, jb.bytes_up)
    np.testing.assert_array_equal(tb.bytes_down, jb.bytes_down)
    assert tb.staleness(now) == jb.staleness(now)
    assert tb.last_staleness == jb.last_staleness
    np.testing.assert_allclose(tb.fed.server.repo_logp.numpy(),
                               np.asarray(jb.fed.server.repo_logp),
                               atol=1e-6)
    np.testing.assert_array_equal(tb.fed.server.active.numpy(),
                                  np.asarray(jb.fed.server.active))
    if jb.fed.targets is not None:
        np.testing.assert_allclose(tb.fed.targets.numpy(),
                                   np.asarray(jb.fed.targets), atol=1e-6)


def _drive(buses, steps):
    """Deliver (t, seed, rows, produced_at) to both buses; returns the
    fire flags, asserting both agree after every step."""
    jb, tb = buses
    fired = []
    for t, seed, rows, produced in steps:
        if seed is None:
            a, b = jb.tick(t), tb.tick(t)
        else:
            msg = _msg(seed)
            a = jb.deliver(t, msg, rows, produced_at=produced)
            b = tb.deliver(t, torch.from_numpy(msg), rows,
                           produced_at=produced)
        assert a == b
        fired.append(b)
        _assert_buses_equal(jb, tb, t)
    return fired


def test_bus_merges_stale_rows_never_drops():
    buses = _buses(lambda m: "every-upload")
    assert _drive(buses, [(0.0, 0, np.ones(NB, bool), None),
                          (5.0, 1, _rows(2), 3.0)]) == [True, True]
    tb = buses[1]
    repo = tb.fed.server.repo_logp.numpy()
    np.testing.assert_allclose(repo[2], _msg(1)[2], atol=1e-6)
    for i in (0, 1, 3):
        np.testing.assert_allclose(repo[i], _msg(0)[i], atol=1e-6)
    s = tb.staleness(5.0)
    assert s["n"] == 4 and s["max"] == pytest.approx(5.0)
    assert s["mean"] == pytest.approx((5 + 5 + 2 + 5) / 4)
    assert tb.n_triggers == 2 and tb.n_uploads == 5


def test_bus_out_of_order_upload_is_superseded_yet_charged():
    buses = _buses(lambda m: "every-upload")
    _drive(buses, [(5.0, 0, _rows(2), 4.0), (6.0, 1, _rows(2), 2.0)])
    tb = buses[1]
    np.testing.assert_allclose(tb.fed.server.repo_logp.numpy()[2],
                               _msg(0)[2], atol=1e-6)
    assert tb.last_upload_t[2] == 4.0 and tb.n_uploads == 1
    assert tb.bytes_up[2] == 2 * R * C * 4     # both uploads paid the link


def test_bus_quorum_counts_distinct_uploaders():
    buses = _buses(lambda m: m.Quorum(count=2), delta=True)
    assert _drive(buses, [(0.0, 0, _rows(0), None),
                          (1.0, 1, _rows(0), None),
                          (2.0, 2, _rows(3), None)]) == [False, False, True]
    assert buses[1].n_triggers == 1 and not buses[1].fresh_since_fire.any()


def test_bus_wall_ticks_fire_only_on_new_uploads():
    buses = _buses(lambda m: m.WallInterval(period=1.0))
    assert _drive(buses, [(0.0, None, None, None), (0.5, 0, _rows(1), None),
                          (1.0, None, None, None), (2.0, None, None, None),
                          (2.5, 1, _rows(0, 3), 1.5),
                          (3.0, None, None, None)]) == \
        [False, False, True, False, False, True]


def test_bus_state_dict_round_trip():
    """A bus restored from ``state_dict`` fires at the same delivery as
    the uninterrupted one, in both packages."""
    first = _buses(lambda m: m.EveryKUploads(k=3))
    _drive(first, [(0.0, 0, _rows(0), None), (1.0, 1, _rows(1), None)])
    second = _buses(lambda m: m.EveryKUploads(k=3))
    for old, new in zip(first, second):
        new.fed.server = old.fed.server      # what a checkpoint also holds
        new.load_state_dict(old.state_dict())
    _assert_buses_equal(*second, 1.0)
    assert second[1].uploads_since_fire == 2 and second[1].n_uploads == 2
    state = first[1].state_dict()
    assert set(state) == set(first[0].state_dict())
    state["bytes_up"][:] = -1.0      # neither side aliases a saved state
    assert (first[1].bytes_up >= 0).all() and (second[1].bytes_up >= 0).all()
    for buses in (first, second):
        assert _drive(buses, [(2.0, 2, _rows(2), None)]) == [True]
    assert first[1].staleness(3.0) == second[1].staleness(3.0)


def test_bus_legacy_none_restores_fresh_counters():
    buses = _buses(lambda m: m.EveryKUploads(k=2))
    _drive(buses, [(0.0, 0, np.ones(NB, bool), None)])
    for b in buses:
        b.load_state_dict(None)
    _assert_buses_equal(*buses, 0.0)
    tb = buses[1]
    assert tb.uploads_since_fire == tb.n_uploads == tb.n_triggers == 0
    assert np.isinf(tb.last_upload_t).all() and tb.bytes_up.sum() == 0
    assert _drive(buses, [(1.0, 1, _rows(3), None),
                          (2.0, 2, np.ones(NB, bool), None)]) == \
        [False, True]


# --- History --------------------------------------------------------------

def test_history_helpers_match_reference():
    acc = [np.array([0.2, 0.6, 0.9]), np.array([0.5, 0.7, 0.4]),
           np.array([0.3, 0.3, 0.8])]
    hs = [m.History(rounds=[0, 1, 2], mean_acc=[a.mean() for a in acc],
                    per_client_acc=acc, val_acc=[0.1, 0.7, 0.4])
          for m in (J, T)]
    jh, th = hs
    assert th.mean_loss == jh.mean_loss == []
    for mask in (None, np.array([True, False, True])):
        assert th.final_metrics(mask) == jh.final_metrics(mask)
    np.testing.assert_array_equal(th.selected_per_client(),
                                  jh.selected_per_client())
    assert th.best_round_idx == jh.best_round_idx == 1


# --- the federate CLI against the reference's ----------------------------

def _reference_summary(monkeypatch, capsys, argv):
    from repro.launch import federate as jax_federate
    monkeypatch.setattr("sys.argv", ["federate", *argv, "--backend", "jnp"])
    jax_federate.main()
    out = capsys.readouterr().out
    return json.loads(out[out.index("\n{\n") + 1:])


@pytest.mark.parametrize("argv", [
    ["--clock", "event", "--arrivals", "straggler-latency", "--trigger",
     "quorum", "--latency", "1.5", "--until", "4"],
    ["--schedule", "dropout", "--dropout-p", "0.3", "--local-steps", "2"]])
def test_federate_cli_matches_reference_summary(monkeypatch, capsys, argv):
    common = ["--rounds", "4", "--eval-every", "2", "--samples-per-client",
              "12", "--ref-size", "12", "--q", "4", "--k", "2"]
    want = _reference_summary(monkeypatch, capsys, [*common, *argv])
    got = federate.main(["--device", "cpu", *common, *argv])
    assert capsys.readouterr().out.rstrip().endswith("}")
    assert set(want) <= set(got)
    # the bookkeeping draws numpy only: equal; accuracies are trained
    # from other draws and only checked for range
    for key in ("policy", "dataset", "clock", "rounds", "virtual_time",
                "server_rounds", "staleness", "uplink", "downlink",
                "bytes_up", "bytes_down", "arrivals", "trigger",
                "schedule"):
        assert got.get(key) == want.get(key), key
    assert got["local_steps"] == (2 if "--local-steps" in argv else 1)
    assert 0.0 <= got["final_acc"] <= 1.0 and got["device"] == "cpu"


def test_federate_cli_rejects_bad_event_arguments():
    for bad in (["--local-steps", "0"],
                ["--clock", "event", "--arrivals", "nope"],
                ["--clock", "event", "--trigger", "nope"],
                ["--schedule", "nope"]):
        with pytest.raises(SystemExit):
            federate.main(["--device", "cpu", "--rounds", "1", *bad])
    with pytest.raises(ValueError, match="Trigger"):
        federate.main(["--device", "cpu", "--rounds", "2",
                       "--samples-per-client", "12", "--ref-size", "12",
                       "--clock", "event", "--interval", "2"])
