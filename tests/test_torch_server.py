"""The port's server round against a live run of the reference's.

Identical numpy-seeded repositories go through ``repro``'s
``policy_round`` (kernel backend ``jnp``) and ``repro_torch``'s on the
CPU. The graph must agree exactly: ``weights`` equal everywhere (each
entry is 1/count of a row's realized edges), ``neighbors`` equal where
their weight is > 0 (a slot with no realized edge holds an arbitrary
index). Quality and targets agree to fp32 rounding (1e-4 relative on
grades of ~R*log C, 1e-6 absolute on probabilities); divergences to
1e-5 absolute.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init_server as jax_init_server
from repro.core import policy_round as jax_policy_round
from repro.core import sqmd as jax_sqmd
from repro.core import upload_messengers as jax_upload
from repro.core.policies import as_policy as jax_as_policy
from repro_torch.core import (ServerBus, graph_stats, init_server,
                              policy_round, server_round, sqmd,
                              upload_messengers)
from repro_torch.core import wire
from repro_torch.core.policies import as_policy


def _log_softmax_np(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _repository(n, r, c, seed, uploaded):
    """Server states in both packages: ``uploaded`` rows carry seeded
    messengers and are active; the rest stay uniform and idle."""
    rng = np.random.default_rng(seed)
    logp = _log_softmax_np(rng.normal(size=(n, r, c)) * 2.0)
    labels = rng.integers(0, c, r).astype(np.int32)
    up = np.asarray(uploaded, bool)
    js = jax_upload(jax_init_server(n, r, c), jnp.asarray(logp),
                    jnp.asarray(up))
    ts = upload_messengers(init_server(n, r, c, device="cpu"),
                           torch.from_numpy(logp), torch.from_numpy(up))
    return js, ts, labels


def _both_rounds(js, ts, labels, q, k):
    jnew, jtargets, jgraph = jax_policy_round(
        js, jax_as_policy(jax_sqmd(q=q, k=k)), jnp.asarray(labels),
        backend="jnp")
    tnew, ttargets, tgraph = policy_round(
        ts, as_policy(sqmd(q=q, k=k)), torch.from_numpy(labels))
    return (jnew, jtargets, jgraph), (tnew, ttargets, tgraph)


def _assert_rounds_agree(j, t):
    (jnew, jtargets, jgraph), (tnew, ttargets, tgraph) = j, t
    np.testing.assert_allclose(tnew.quality.numpy(), np.asarray(jnew.quality),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tgraph.candidates.numpy(),
                                  np.asarray(jgraph.candidates))
    jw = np.asarray(jgraph.weights)
    np.testing.assert_array_equal(tgraph.weights.numpy(), jw)
    jn = np.asarray(jgraph.neighbors)
    tn = tgraph.neighbors.numpy()
    assert tn.shape == jn.shape and tn.dtype == np.int32
    realized = np.take_along_axis(jw, jn, axis=1) > 0
    np.testing.assert_array_equal(tn[realized], jn[realized])
    np.testing.assert_allclose(tgraph.divergence.numpy(),
                               np.asarray(jgraph.divergence), atol=1e-5)
    np.testing.assert_allclose(ttargets.numpy(), np.asarray(jtargets),
                               atol=1e-6)
    np.testing.assert_array_equal(tnew.weights.numpy(),
                                  np.asarray(jnew.weights))
    assert int(tnew.round) == int(jnew.round)
    return realized


@pytest.mark.parametrize("n,r,c,q,k", [(20, 16, 4, 8, 4), (30, 24, 3, 8, 4),
                                       (37, 13, 5, 16, 8)])
def test_policy_round_matches_reference(n, r, c, q, k):
    js, ts, labels = _repository(n, r, c, n, np.ones(n, bool))
    realized = _assert_rounds_agree(*_both_rounds(js, ts, labels, q, k))
    assert realized.all()                  # every client got k edges


@pytest.mark.parametrize("n,r,c", [(20, 16, 4), (28, 30, 2), (37, 13, 5)])
def test_policy_round_on_all_uniform_repository(n, r, c):
    """Round-0 repository: every row uniform, every client active. Every
    grade and every divergence ties, so the whole graph is decided by
    lowest-index tie-breaks (the quality pool is clients 0..q-1)."""
    js, ts, labels = _repository(n, r, c, 1, np.zeros(n, bool))
    act = np.ones(n, bool)
    js = js._replace(active=jnp.asarray(act))
    ts = ts._replace(active=torch.from_numpy(act))
    j, t = _both_rounds(js, ts, labels, q=8, k=4)
    _assert_rounds_agree(j, t)
    cand = t[2].candidates.numpy()
    np.testing.assert_array_equal(np.nonzero(cand)[0], np.arange(8))
    # every target is the uniform distribution
    np.testing.assert_allclose(t[1].numpy(), 1.0 / c, atol=1e-6)


@pytest.mark.parametrize("n_up", [3, 6, 12])
def test_policy_round_staged_join_with_idle_rows(n_up):
    """A staged-join repository: the first n_up clients uploaded, the
    rest are idle uniform rows outside the pool. With n_up <= k some rows
    realize fewer than K edges and carry zero-weight slots."""
    n, r, c = 20, 16, 3
    up = np.arange(n) < n_up
    js, ts, labels = _repository(n, r, c, 2, up)
    realized = _assert_rounds_agree(*_both_rounds(js, ts, labels, q=8, k=4))
    if n_up <= 4:
        assert not realized.all()


def test_init_server_and_upload_match_reference():
    n, r, c = 9, 7, 3
    jinit = jax_init_server(n, r, c)
    tinit = init_server(n, r, c, device="cpu")
    for name in ("repo_logp", "active", "quality", "sim", "weights",
                 "div_cache"):
        np.testing.assert_array_equal(getattr(tinit, name).numpy(),
                                      np.asarray(getattr(jinit, name)))
    # a wire payload merges only its uploading rows, like a raw stack
    rng = np.random.default_rng(3)
    logp = torch.from_numpy(_log_softmax_np(rng.normal(size=(n, r, c))))
    up = torch.from_numpy(rng.random(n) < 0.5)
    via_wire = upload_messengers(tinit, wire.encode("dense32", logp), up)
    raw = upload_messengers(tinit, logp, up)
    np.testing.assert_array_equal(via_wire.repo_logp.numpy(),
                                  raw.repo_logp.numpy())
    np.testing.assert_array_equal(via_wire.active.numpy(), up.numpy())


def test_server_round_and_graph_stats():
    n, r, c = 16, 10, 3
    js, ts, labels = _repository(n, r, c, 4, np.ones(n, bool))
    new, targets = server_round(ts, sqmd(q=8, k=4), torch.from_numpy(labels))
    assert targets.shape == (n, r, c) and int(new.round) == 1
    np.testing.assert_allclose(targets.sum(-1).numpy(), 1.0, atol=1e-5)
    (_, _, jgraph), (_, _, tgraph) = _both_rounds(js, ts, labels, 8, 4)
    from repro.core.graph import graph_stats as jax_graph_stats
    assert graph_stats(tgraph) == pytest.approx(jax_graph_stats(jgraph))


def test_server_bus_meters_dense32_bytes():
    """One delivery + fire: every uploader pays R*C*4 wire bytes up, every
    active receiver the same down."""
    n, r, c = 12, 5, 3
    _, ts, labels = _repository(n, r, c, 5, np.zeros(n, bool))

    class _Fed:
        server = ts
        ref_y = torch.from_numpy(labels)
        n_clients = n
        targets = None

    fed = _Fed()
    bus = ServerBus(fed, as_policy(sqmd(q=4, k=2)))
    rng = np.random.default_rng(6)
    msg = torch.from_numpy(_log_softmax_np(rng.normal(size=(n, r, c))))
    up = np.arange(n) < 7
    assert bus.deliver(0.0, wire.encode("dense32", msg), up)
    assert bus.n_triggers == 1 and bool(fed.server.active.eq(
        torch.from_numpy(up)).all())
    np.testing.assert_array_equal(bus.bytes_up, np.where(up, r * c * 4, 0))
    np.testing.assert_array_equal(bus.bytes_down, np.where(up, r * c * 4, 0))
    # rows that received nothing hold zero targets
    assert float(fed.targets[~torch.from_numpy(up)].abs().sum()) == 0.0
    assert bus.staleness(1.0)["n"] == 7
