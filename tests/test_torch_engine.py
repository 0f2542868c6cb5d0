"""The port's synchronous federation, end to end, against a live run of
the reference's (never against its PINNED_* constants).

The fixture of tests/test_runtime.py::setup: pad_like(30, 30, 24), splits
seed 0, sqmd(q=8, k=4), 4 rounds, batch 8, eval_every 2, seed 7. The
reference runs on kernel backend ``jnp``; its initial params and its
threefry batch draws (``rng, sub = split(rng)``, then
``randint(sub, (n_c, B), 0, m)`` per step and cohort in build order) are
fed to the port through ``init_params`` and ``batch_indices``.

Over four rounds the two frameworks' fp32 roundings drift apart a little:
eval logits must agree to LOGIT_TOL, and a test prediction may differ
only where the reference's top-two logits lie within 2 * LOGIT_TOL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FederationConfig as JaxConfig
from repro.core import FederationEngine as JaxEngine
from repro.core import sqmd as jax_sqmd
from repro.data import make_splits as jax_make_splits
from repro.data import pad_like as jax_pad_like
from repro.models.mlp import hetero_mlp_zoo as jax_zoo
from repro_torch.core import FederationConfig, FederationEngine, sqmd
from repro_torch.data import make_splits, pad_like
from repro_torch.launch import federate
from repro_torch.models import hetero_mlp_zoo

LOGIT_TOL = 1e-4
CFG = dict(rounds=4, batch_size=8, eval_every=2)
SEED = 7


def _stack_test(splits, ids):
    return (np.stack([splits[i].test_x for i in ids]),
            np.stack([splits[i].test_y for i in ids]))


def _record_fires(bus, out):
    """Keep the graph of every fire (callbacks see only eval rounds)."""
    fire = bus.fire

    def recording(t):
        fire(t)
        out.append(bus.last_graph)

    bus.fire = recording


def _run_both(jprotocol=None, tprotocol=None, **server):
    """The fixture federation in both packages, under ``jprotocol`` (the
    reference's) and ``tprotocol`` (the port's; both sqmd(q=8, k=4) by
    default), with ``server`` config (delta_graph / selection / uplink /
    downlink) on both sides. A policy with a static graph (D-Dist) gets
    the reference's own draw through ``build(static_weights=)``."""
    if jprotocol is None:
        jprotocol, tprotocol = jax_sqmd(q=8, k=4), sqmd(q=8, k=4)
    ds = jax_pad_like(samples_per_client=30, ref_size=30, length=24)
    splits = jax_make_splits(ds, seed=0)
    zoo = jax_zoo(ds.feature_len, ds.n_classes)
    assignment = [list(zoo)[i % 3] for i in range(ds.n_clients)]

    jlogits, tlogits = [], []

    def jcb(engine, rnd, metrics):
        out = np.zeros((ds.n_clients, len(splits[0].test_y), ds.n_classes))
        for coh in engine.fed.cohorts:
            xs, _ = _stack_test(splits, coh.client_ids)
            out[coh.client_ids] = np.asarray(
                jax.vmap(coh.apply_fn)(coh.params, jnp.asarray(xs)))
        jlogits.append(out)

    jeng = JaxEngine.build(ds, splits, zoo, assignment, jprotocol,
                           config=JaxConfig(**CFG, **server, backend="jnp"),
                           seed=SEED, callbacks=[jcb])
    jfires, tfires = [], []
    _record_fires(jeng.bus, jfires)
    init_params = {coh.family_name: jax.tree.map(np.asarray, coh.params)
                   for coh in jeng.fed.cohorts}
    draws = {}
    rng = jeng.fed.rng
    for step in range(CFG["rounds"]):
        for ci, coh in enumerate(jeng.fed.cohorts):
            rng, sub = jax.random.split(rng)
            n_c, m = coh.data["y"].shape
            draws[step, ci] = np.asarray(jax.random.randint(
                sub, (n_c, CFG["batch_size"]), 0, m))
    jhist = jeng.fit(splits)

    pds = pad_like(samples_per_client=30, ref_size=30, length=24)
    psplits = make_splits(pds, seed=0)

    def tcb(engine, rnd, metrics):
        out = np.zeros((pds.n_clients, len(psplits[0].test_y),
                        pds.n_classes))
        for coh in engine.fed.cohorts:
            xs, _ = _stack_test(psplits, coh.client_ids)
            with torch.no_grad():
                out[coh.client_ids] = coh.model(torch.from_numpy(xs)).numpy()
        tlogits.append(out)

    static = getattr(jeng.policy, "static_weights", None)
    teng = FederationEngine.build(
        pds, psplits, hetero_mlp_zoo(pds.feature_len, pds.n_classes),
        assignment, tprotocol, config=FederationConfig(**CFG, **server),
        seed=SEED, callbacks=[tcb], device="cpu", init_params=init_params,
        batch_indices=lambda step, ci: draws[step, ci],
        static_weights=None if static is None else np.asarray(static))
    _record_fires(teng.bus, tfires)
    thist = teng.fit(psplits)
    return dict(jeng=jeng, teng=teng, jhist=jhist, thist=thist,
                jlogits=jlogits, tlogits=tlogits, splits=splits,
                jfires=jfires, tfires=tfires)


@pytest.fixture(scope="module")
def runs():
    return _run_both()


# the slice's other server paths: delta rounds on the exact cache, and
# delta rounds on the IVF index with the int8 uplink
SERVER_PATHS = {"delta": dict(delta_graph=True),
                "ivf-int8": dict(delta_graph=True, selection="ivf",
                                 uplink="int8")}


@pytest.fixture(scope="module", params=list(SERVER_PATHS))
def server_runs(request):
    return _run_both(**SERVER_PATHS[request.param])


def test_history_bookkeeping_matches(runs):
    jh, th = runs["jhist"], runs["thist"]
    assert th.rounds == jh.rounds == [0, 2, 3]
    assert th.times == jh.times
    assert th.server_rounds == jh.server_rounds == [1, 3, 4]
    assert th.bytes_up == jh.bytes_up and th.bytes_down == jh.bytes_down
    assert th.staleness == jh.staleness
    for a, b in zip(th.graph_stats, jh.graph_stats):
        assert a == pytest.approx(b)


def test_eval_logits_match(runs):
    assert len(runs["tlogits"]) == len(runs["jlogits"]) == 3
    for t, j in zip(runs["tlogits"], runs["jlogits"]):
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, rtol=0)


def test_per_client_accuracy_matches_up_to_near_ties(runs):
    """Accuracy per client and eval matches; a prediction may flip only
    where the reference's top-two logits are within 2 * LOGIT_TOL."""
    splits = runs["splits"]
    ys = np.stack([s.test_y for s in splits])
    for t, j, ta, ja in zip(runs["tlogits"], runs["jlogits"],
                            runs["thist"].per_client_acc,
                            runs["jhist"].per_client_acc):
        flips = t.argmax(-1) != j.argmax(-1)
        top2 = np.sort(j, axis=-1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0])[flips].max(initial=0.0) \
            < 2 * LOGIT_TOL
        per_client_flips = flips.sum(-1)
        n_test = ys.shape[1]
        assert np.all(np.abs(ta - ja) * n_test <= per_client_flips + 1e-6)
    np.testing.assert_allclose(runs["thist"].mean_acc,
                               runs["jhist"].mean_acc, atol=0.05)


def test_final_server_state_matches(runs):
    js, ts = runs["jeng"].server, runs["teng"].server
    np.testing.assert_array_equal(ts.weights.numpy(), np.asarray(js.weights))
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    np.testing.assert_allclose(ts.repo_logp.numpy(), np.asarray(js.repo_logp),
                               atol=LOGIT_TOL)
    assert int(ts.round) == int(js.round) == 4


def test_final_targets_match_reference(runs):
    """The last fire's targets, gathered over the port's neighbor lists,
    equal the reference's dense-W neighbor mean of its own fire."""
    jt, tt = runs["jeng"].fed.targets, runs["teng"].fed.targets
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=LOGIT_TOL)


def test_quickstart_report_matches_reference(runs):
    """The quickstart walkthrough's report read off both packages'
    engines: the last graph's stats and the neighbor/cluster agreement
    (the fixture's final W is the reference's, edge for edge)."""
    from repro.core import graph_stats as jax_graph_stats
    from repro_torch.core import graph_stats
    from repro_torch.examples.quickstart import cluster_agreement
    jeng, teng = runs["jeng"], runs["teng"]
    cluster = pad_like(samples_per_client=30, ref_size=30,
                       length=24).client_cluster
    tstats = graph_stats(teng.last_graph)
    assert tstats == pytest.approx(jax_graph_stats(jeng.last_graph))
    assert tstats["n_candidates"] == 8 and tstats["out_degree"] == 4.0
    assert cluster_agreement(teng.server.weights.numpy(), cluster) == \
        cluster_agreement(np.asarray(jeng.server.weights), cluster)


def _assert_slots_scatter_to_weights(fires):
    for g in fires:
        n, k = g.neighbors.shape
        assert g.slot_weights is not None and g.slot_weights.shape == (n, k)
        w = torch.zeros((n, n))
        w.index_put_((torch.arange(n).repeat_interleave(k),
                      g.neighbors.reshape(-1).long()),
                     g.slot_weights.reshape(-1), accumulate=True)
        np.testing.assert_array_equal(w.numpy(), g.weights.numpy())


def test_fire_graphs_carry_slot_weights(runs):
    """Every fire's graph carries the per-slot weights emit_targets
    gathers with, and they scatter back to exactly its dense W."""
    _assert_slots_scatter_to_weights(runs["tfires"])


def test_server_paths_fire_graphs_carry_slot_weights(server_runs):
    _assert_slots_scatter_to_weights(server_runs["tfires"])


def test_server_paths_pick_the_same_edges_up_to_near_ties(server_runs):
    """Per fire, each client's neighbor set equals the reference's, or the
    differing picks are near-ties: the sorted similarities of the two
    sets agree to 1e-4 relative."""
    jf, tf = server_runs["jfires"], server_runs["tfires"]
    assert len(jf) == len(tf) == CFG["rounds"]
    ivf = server_runs["teng"].policy.selection == "ivf"
    for jg, tg in zip(jf, tf):
        assert (tg.divergence is None) == ivf
        np.testing.assert_array_equal(tg.candidates.numpy(),
                                      np.asarray(jg.candidates))
        jw, tw = np.asarray(jg.weights), tg.weights.numpy()
        jsim, tsim = np.asarray(jg.similarity), tg.similarity.numpy()
        for i in range(jw.shape[0]):
            je, te = np.nonzero(jw[i])[0], np.nonzero(tw[i])[0]
            if np.array_equal(je, te):
                continue
            np.testing.assert_allclose(np.sort(tsim[i, te]),
                                       np.sort(jsim[i, je]), rtol=1e-4)


def test_server_paths_eval_logits_match(server_runs):
    jh, th = server_runs["jhist"], server_runs["thist"]
    assert th.server_rounds == jh.server_rounds == [1, 3, 4]
    assert th.bytes_up == jh.bytes_up and th.bytes_down == jh.bytes_down
    assert len(server_runs["tlogits"]) == len(server_runs["jlogits"]) == 3
    for t, j in zip(server_runs["tlogits"], server_runs["jlogits"]):
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, rtol=0)
    teng = server_runs["teng"]
    assert teng.bus.delta and teng.fed.uplink == teng.config.uplink
    if teng.policy.selection == "ivf":
        assert teng.policy._ivf is not None
        assert int(teng.policy._ivf.active_rows().sum()) == teng.n_clients


def test_config_validation():
    assert FederationConfig().selection == "exact"
    cfg = FederationConfig(selection="ivf", delta_graph=True, uplink="int8",
                           downlink="int8")
    assert cfg.selection == "ivf" and cfg.uplink == "int8"
    with pytest.raises(ValueError, match="delta_graph"):
        FederationConfig(selection="ivf")
    with pytest.raises(ValueError, match="selection"):
        FederationConfig(selection="bogus", delta_graph=True)
    with pytest.raises(ValueError, match="uplink"):
        FederationConfig(uplink="no-such-codec")
    with pytest.raises(ValueError, match="downlink"):
        FederationConfig(downlink="no-such-codec")
    with pytest.raises(ValueError, match="no argument"):
        FederationConfig(uplink="int8:3")
    with pytest.raises(ValueError):
        FederationConfig(rounds=-1)


def test_build_defaults_to_the_card():
    """Without ``device=`` the engine goes to CUDA: on a machine without a
    card that is an error naming the CPU escape hatch, never a silent
    fallback."""
    ds = pad_like(samples_per_client=10, ref_size=6, length=8)
    splits = make_splits(ds, seed=0)
    zoo = hetero_mlp_zoo(ds.feature_len, ds.n_classes)
    if torch.cuda.is_available():
        eng = FederationEngine.build(ds, splits, zoo, None, sqmd(q=4, k=2))
        assert eng.fed.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederationEngine.build(ds, splits, zoo, None, sqmd(q=4, k=2))


def test_federate_cli_on_cpu(capsys):
    summary = federate.main(["--device", "cpu", "--rounds", "2",
                             "--samples-per-client", "12", "--ref-size",
                             "12", "--schedule", "staged-join", "--q", "4",
                             "--k", "2"])
    assert summary["device"] == "cpu" and summary["server_rounds"] == 2
    assert 0.0 <= summary["final_acc"] <= 1.0
    assert '"policy": "sqmd"' in capsys.readouterr().out


def test_federate_cli_ivf_int8_on_cpu(capsys):
    summary = federate.main(["--device", "cpu", "--rounds", "2",
                             "--samples-per-client", "12", "--ref-size",
                             "12", "--q", "4", "--k", "2", "--delta",
                             "--selection", "ivf", "--uplink", "int8",
                             "--downlink", "int8"])
    assert summary["selection"] == "ivf" and summary["uplink"] == "int8"
    assert summary["server_rounds"] == 2
    ds = pad_like(samples_per_client=12, ref_size=12)
    # int8 wire: R*(C+4) bytes a messenger each way, every round
    assert summary["bytes_up"] == summary["bytes_down"] \
        == 2 * ds.n_clients * 12 * (ds.n_classes + 4)
    for bad in (["--selection", "ivf"], ["--uplink", "nope"],
                ["--downlink", "int8:2"]):
        with pytest.raises(SystemExit):
            federate.main(["--device", "cpu", "--rounds", "1", *bad])


def test_graph_stats_out_degree_is_the_references_mean():
    """``out_degree`` reads as the reference's ``jnp.mean`` reads it (the
    fp32 sum times the fp32 reciprocal of the count: 6.000000476837158
    for 28 rows of 6, where torch.mean read 6.0 on the CPU), on even rows
    and on rows every fourth of which is one short; computed on the host,
    so the card reads the same bits."""
    from repro.core import graph_stats as jax_graph_stats
    from repro.core.graph import CollaborationGraph as JaxGraph
    from repro_torch.core import graph_stats
    from repro_torch.core.graph import CollaborationGraph
    n, k = 28, 6
    rng = np.random.default_rng(n)
    for short in (0, 1):
        w = np.zeros((n, n), np.float32)
        for i in range(n):
            deg = k - short if i % 4 == 0 else k
            w[i, rng.choice(n, deg, replace=False)] = 1.0 / deg
        cand = np.ones(n, bool)
        tstats = graph_stats(CollaborationGraph(
            torch.zeros((n, k), dtype=torch.int32), torch.from_numpy(w),
            torch.zeros((n, n)), torch.from_numpy(cand)))
        jstats = jax_graph_stats(JaxGraph(
            jnp.zeros((n, k), jnp.int32), jnp.asarray(w), jnp.zeros((n, n)),
            jnp.asarray(cand)))
        assert tstats["out_degree"] == jstats["out_degree"]
        assert tstats == jstats
    assert tstats["out_degree"] == 5.750000476837158    # 161 / 28
