"""The port's baseline policies (FedMD, D-Dist, I-SGD) and the
communication interval, against live runs of the reference's.

A server round: identical numpy-seeded repositories, some clients never
uploaded (inactive), go through an SQMD round (so ``state.sim`` holds a
similarity matrix) and then the baseline's round in both packages
(reference kernel backend ``jnp``, the port on the CPU). Quality, dense
weights, targets, ``state.sim`` and receivers must agree within
TOL = (atol 1e-6, rtol 1e-5): fp32 sums of at most N products in another
order, on grades of ~R*log C and probabilities <= 1. D-Dist's static
graph is the reference's threefry draw, injected into the port through
``attach_static_weights`` (the port draws from a torch.Generator, which
cannot reproduce threefry); the port's own draws are held to the
reference's properties instead.

A federation: the fixture of tests/test_torch_engine.py under each
baseline and under sqmd with interval 2, the reference's initial params
and batch draws fed through the port's seams; eval logits within that
file's LOGIT_TOL, server rounds and wire bytes exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ddist as jax_ddist
from repro.core import ddist_graph as jax_ddist_graph
from repro.core import fedmd as jax_fedmd
from repro.core import init_server as jax_init_server
from repro.core import isgd as jax_isgd
from repro.core import policy_round as jax_policy_round
from repro.core import server_round as jax_server_round
from repro.core import sqmd as jax_sqmd
from repro.core import upload_messengers as jax_upload
from repro.core.policies import as_policy as jax_as_policy
from repro_torch.convert import static_weights_from_numpy
from repro_torch.core import (DDistPolicy, Protocol, ddist, ddist_graph,
                              fedmd, fedmd_graph, init_server, isgd,
                              policy_round, server_round, sqmd,
                              upload_messengers)
from repro_torch.core.policies import as_policy
from repro_torch.data import pad_like
from repro_torch.kernels import ref
from repro_torch.launch import federate
from test_torch_engine import CFG, LOGIT_TOL, _run_both

TOL = dict(atol=1e-6, rtol=1e-5)
N, R, C, K = 12, 16, 4, 3
JAX = {"fedmd": jax_fedmd, "isgd": jax_isgd,
       "ddist": lambda: jax_ddist(k=K)}
TORCH = {"fedmd": fedmd, "isgd": isgd, "ddist": lambda: ddist(k=K)}


def _log_softmax_np(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _static_graph():
    """The reference's D-Dist draw over all N clients, and an upload mask
    that leaves client 0's every static neighbor (and client 5) idle, so
    one row renormalizes over no realized edge."""
    w = np.asarray(jax_ddist_graph(jax.random.key(3), N, K).weights)
    up = np.ones(N, bool)
    up[np.nonzero(w[0])[0]] = False
    up[5] = False
    return w, up


def _after_sqmd_round():
    """Both packages' states after an SQMD round on a repository where the
    clients of ``_static_graph``'s mask never uploaded."""
    w, up = _static_graph()
    rng = np.random.default_rng(11)
    logp = _log_softmax_np(rng.normal(size=(N, R, C)) * 2.0)
    labels = rng.integers(0, C, R).astype(np.int32)
    js = jax_upload(jax_init_server(N, R, C), jnp.asarray(logp),
                    jnp.asarray(up))
    ts = upload_messengers(init_server(N, R, C, device="cpu"),
                           torch.from_numpy(logp), torch.from_numpy(up))
    js, _ = jax_server_round(js, jax_sqmd(q=6, k=K), jnp.asarray(labels),
                             backend="jnp")
    ts, _ = server_round(ts, sqmd(q=6, k=K), torch.from_numpy(labels))
    return js, ts, labels, w


def _rounds(name):
    js, ts, labels, w = _after_sqmd_round()
    jpol = jax_as_policy(JAX[name](), static_weights=jnp.asarray(w))
    tpol = as_policy(TORCH[name](), static_weights=w)
    jnew, jt, jg = jax_policy_round(js, jpol, jnp.asarray(labels),
                                    backend="jnp")
    tnew, tt, tg = policy_round(ts, tpol, torch.from_numpy(labels))
    return dict(js=js, ts=ts, labels=labels, w=w, jpol=jpol, tpol=tpol,
                jnew=jnew, jt=jt, jg=jg, tnew=tnew, tt=tt, tg=tg)


@pytest.mark.parametrize("name", ["fedmd", "isgd", "ddist"])
def test_server_round_matches_reference(name):
    r = _rounds(name)
    jnew, tnew = r["jnew"], r["tnew"]
    assert not np.asarray(r["js"].active).all()      # some clients idle
    for field in ("quality", "weights", "sim"):
        np.testing.assert_allclose(getattr(tnew, field).numpy(),
                                   np.asarray(getattr(jnew, field)), **TOL)
    np.testing.assert_allclose(r["tt"].numpy(), np.asarray(r["jt"]), **TOL)
    np.testing.assert_allclose(r["tg"].weights.numpy(),
                               np.asarray(r["jg"].weights), **TOL)
    np.testing.assert_array_equal(
        r["tpol"].receivers(tnew, r["tg"]).numpy(),
        np.asarray(r["jpol"].receivers(jnew, r["jg"])))
    assert int(tnew.round) == int(jnew.round) == 2
    # the public entry, with the static graph as an argument, is the same
    # round
    new, targets = server_round(r["ts"], TORCH[name](),
                                torch.from_numpy(r["labels"]),
                                static_weights=r["w"])
    torch.testing.assert_close(targets, r["tt"], rtol=0, atol=0)
    torch.testing.assert_close(new.weights, tnew.weights, rtol=0, atol=0)


def test_fedmd_round_after_sqmd_keeps_the_reference_sim():
    """FedMD computes no similarity: its round keeps the SQMD round's
    ``state.sim``, as the reference's does, and does not store its
    uniform W there."""
    r = _rounds("fedmd")
    np.testing.assert_allclose(r["tnew"].sim.numpy(),
                               np.asarray(r["jnew"].sim), **TOL)
    torch.testing.assert_close(r["tnew"].sim, r["ts"].sim, rtol=0, atol=0)
    assert not torch.equal(r["tnew"].sim, r["tg"].weights)


def test_ddist_takes_the_gather_on_its_static_lists():
    """D-Dist's graph carries the static lists (each row's nonzeros in
    ascending column order) with this round's renormalized slot weights;
    they scatter to its dense W, a row with no realized edge receives
    nothing, and the gathered targets equal the dense product."""
    r = _rounds("ddist")
    tg, w = r["tg"], r["w"]
    nbrs, slots = tg.neighbors.long(), tg.slot_weights
    for i in range(N):
        cols = np.nonzero(w[i])[0]
        np.testing.assert_array_equal(nbrs[i, :len(cols)].numpy(), cols)
    dense = torch.zeros((N, N))
    dense.index_put_((torch.arange(N).repeat_interleave(nbrs.shape[1]),
                      nbrs.reshape(-1)), slots.reshape(-1), accumulate=True)
    torch.testing.assert_close(dense, tg.weights, rtol=0, atol=0)
    assert not bool(r["tpol"].receivers(r["tnew"], tg)[0])
    assert float(slots[0].abs().sum()) == 0.0
    probs = torch.exp(r["ts"].repo_logp)
    np.testing.assert_allclose(r["tt"].numpy(),
                               ref.neighbor_mean_ref(tg.weights,
                                                     probs).numpy(), **TOL)


def test_isgd_server_round_is_empty():
    r = _rounds("isgd")
    assert r["tg"].neighbors.shape == (N, 0)
    assert float(r["tt"].abs().max()) == 0.0
    assert not bool(r["tpol"].receivers(r["tnew"], r["tg"]).any())


def test_ddist_setup_and_attach_leave_the_same_state():
    gen = torch.Generator().manual_seed(4)
    drawn = ddist_graph(gen, N, K).weights
    a = DDistPolicy(ddist(k=K))
    a.setup(torch.Generator().manual_seed(4), N)
    b = DDistPolicy(ddist(k=K))
    b.attach_static_weights(drawn.numpy())
    for t in ("static_weights", "neighbors", "slot_weights"):
        torch.testing.assert_close(getattr(a, t), getattr(b, t), rtol=0,
                                   atol=0)
    assert a.neighbors.dtype == torch.int32
    with pytest.raises(ValueError, match="static graph"):
        as_policy(fedmd()).attach_static_weights(drawn)
    with pytest.raises(ValueError, match="static graph"):
        policy_round(init_server(N, R, C, device="cpu"),
                     as_policy(ddist(k=K)), torch.zeros(R, dtype=torch.int32))


# --- the port's own draws: the properties of test_core_protocol.py -------

def _draw(n, k, active=None, seed=0):
    return ddist_graph(torch.Generator().manual_seed(seed), n, k,
                       None if active is None else torch.as_tensor(active))


@pytest.mark.parametrize("n,k", [(10, 4), (6, 20), (40, 8)])
def test_ddist_graph_properties(n, k):
    active = np.ones(n, bool)
    active[::3] = False
    for act in (None, active):
        g = _draw(n, k, act, seed=n)
        w = g.weights.numpy()
        assert np.allclose(np.diag(w), 0.0)                 # no self-edges
        assert ((w > 0).sum(1) <= k).all()
        realized = w.sum(1) > 0
        np.testing.assert_allclose(w.sum(1)[realized], 1.0, atol=1e-6)
        if act is None:
            assert realized.all()
            assert ((w > 0).sum(1) == min(k, n - 1)).all()
        else:
            assert np.allclose(w[:, ~act], 0.0)    # never samples idle
        assert g.neighbors.shape == g.slot_weights.shape == (n, min(k, n - 1))


def test_ddist_graph_all_inactive_is_nan_free_and_empty():
    g = _draw(7, 3, np.zeros(7, bool))
    assert torch.isfinite(g.weights).all() and float(g.weights.sum()) == 0.0
    assert float(g.slot_weights.abs().sum()) == 0.0


def test_ddist_graph_samples_uniformly_without_replacement():
    """Row 0 of n = 5, k = 2 over 1000 draws: each other client is picked
    in half of them (within 5 standard deviations), never twice a row."""
    hits = np.zeros(5)
    for seed in range(1000):
        row = _draw(5, 2, seed=seed).weights[0].numpy()
        assert (row > 0).sum() == 2
        hits += row > 0
    assert hits[0] == 0
    np.testing.assert_allclose(hits[1:], 500.0, atol=5 * np.sqrt(250.0))


def test_fedmd_graph_is_the_complete_average():
    active = torch.tensor([True, True, True, False])
    g = fedmd_graph(active)
    np.testing.assert_allclose(g.weights[:, :3].numpy(), 1.0 / 3, atol=1e-7)
    assert float(g.weights[:, 3].abs().max()) == 0.0
    assert g.slot_weights is None and g.neighbors.shape == (4, 4)
    empty = fedmd_graph(torch.zeros(4, dtype=torch.bool))
    assert torch.isfinite(empty.weights).all()
    assert float(empty.weights.abs().sum()) == 0.0


def test_protocol_interval_and_reference_use():
    assert sqmd(interval=3).interval == 3 and fedmd(interval=2).interval == 2
    assert ddist(k=5, interval=4).k == 5
    assert isgd().rho == 0.0 and not isgd().uses_reference
    assert fedmd().uses_reference and as_policy(sqmd(interval=2)).interval == 2
    with pytest.raises(ValueError, match="interval"):
        Protocol("fedmd", interval=0)
    w = static_weights_from_numpy(np.eye(3, dtype=np.float64), device="cpu")
    assert w.dtype == torch.float32 and w.device.type == "cpu"
    with pytest.raises(ValueError, match=r"\(N, N\)"):
        static_weights_from_numpy(np.zeros((2, 3)), device="cpu")


# --- federations against the reference's ----------------------------------

FEDERATIONS = {
    "fedmd": (jax_fedmd, fedmd),
    "ddist": (lambda: jax_ddist(k=4), lambda: ddist(k=4)),
    "isgd": (jax_isgd, isgd),
    "sqmd-interval-2": (lambda: jax_sqmd(q=8, k=4, interval=2),
                        lambda: sqmd(q=8, k=4, interval=2)),
}


@pytest.fixture(scope="module", params=list(FEDERATIONS))
def policy_runs(request):
    jproto, tproto = FEDERATIONS[request.param]
    out = _run_both(jproto(), tproto())
    out["name"] = request.param
    return out


def test_federation_matches_reference(policy_runs):
    jh, th = policy_runs["jhist"], policy_runs["thist"]
    name = policy_runs["name"]
    assert th.rounds == jh.rounds
    assert th.server_rounds == jh.server_rounds == {
        "fedmd": [1, 3, 4], "ddist": [1, 3, 4], "isgd": [0, 0, 0],
        "sqmd-interval-2": [1, 2, 2]}[name]
    assert th.bytes_up == jh.bytes_up and th.bytes_down == jh.bytes_down
    if name == "isgd":
        assert th.bytes_up[-1] == th.bytes_down[-1] == 0.0
    assert len(policy_runs["tlogits"]) == len(policy_runs["jlogits"]) == 3
    for t, j in zip(policy_runs["tlogits"], policy_runs["jlogits"]):
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, rtol=0)
    js, ts = policy_runs["jeng"].server, policy_runs["teng"].server
    assert int(ts.round) == int(js.round) == CFG["rounds"]
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    np.testing.assert_allclose(ts.weights.numpy(), np.asarray(js.weights),
                               **TOL)


def test_federation_fires_take_the_policy_graph(policy_runs):
    """FedMD's fires carry only a dense W (the dense Eq. 5 entry), every
    other policy's carry their lists; I-SGD never fires."""
    fires = policy_runs["tfires"]
    assert len(fires) == len(policy_runs["jfires"])
    for g in fires:
        assert (g.slot_weights is None) == (policy_runs["name"] == "fedmd")


@pytest.mark.parametrize("argv,fires", [
    (["--policy", "fedmd", "--interval", "2"], 2),
    (["--policy", "ddist", "--k", "3"], 4)])
def test_federate_cli_baselines_on_cpu(argv, fires):
    summary = federate.main(["--device", "cpu", "--rounds", "4",
                             "--samples-per-client", "12", "--ref-size",
                             "12", "--eval-every", "2", *argv])
    ds = pad_like(samples_per_client=12, ref_size=12)
    assert summary["server_rounds"] == fires
    assert summary["policy"] == argv[1]
    # dense32: 4 bytes a value, every client uploads at every fire
    assert summary["bytes_up"] == fires * ds.n_clients * 12 * ds.n_classes * 4
    assert 0.0 <= summary["final_acc"] <= 1.0
    with pytest.raises(SystemExit):
        federate.main(["--device", "cpu", "--interval", "0"])
