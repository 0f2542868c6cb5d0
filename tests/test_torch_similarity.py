"""The port's delta rounds and IVF neighbor index against the reference's
``repro.core.similarity``, on identical numpy-seeded messengers.

Divergences agree to 1e-5 absolute: both sides reduce in fp32 in other
orders (the reference's fused jnp strips, the port's plain versions).
Index structure — assignments, list ids, selections, degraded-row counts,
centroid count, resident bytes — must be equal: the k-means draws come
from the same numpy generator and every sort is stable.

The probe-all tests mirror tests/test_neighbor_index.py: with
``n_probe >= n_centroids`` the lists are exactly the top-L over active
clients, held against a dense oracle computed off the same int8 round
trip the index stores.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import similarity as jsim
from repro.core import init_server as jax_init_server
from repro.core import policy_round as jax_policy_round
from repro.core import sqmd as jax_sqmd
from repro.core import upload_messengers as jax_upload
from repro.core.policies import as_policy as jax_as_policy
from repro_torch.core import (init_server, policy_round, sqmd,
                              upload_messengers, wire)
from repro_torch.core import similarity as sim
from repro_torch.core.policies import as_policy
from repro_torch.kernels import ops, ref

R, C = 5, 7
PROBE_ALL = 10 ** 6
DIV_TOL = 1e-5


def _log_softmax_np(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _rand_logp(rng, u, r=R, c=C):
    return _log_softmax_np(rng.normal(size=(u, r, c)) * 2.0)


# --------------------------------------------------------------------------
# exact delta path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("u", [1, 2, 3, 5, 8, 13])
def test_bucket_rows_matches_reference(u):
    rows = np.sort(np.random.default_rng(u).choice(40, u, replace=False))
    np.testing.assert_array_equal(sim._bucket_rows(rows),
                                  jsim._bucket_rows(rows))


def test_delta_cache_matches_reference_and_rebuild():
    """A random upload sequence: after every step the port's cache equals
    the reference's delta cache and the port's own full rebuild."""
    rng = np.random.default_rng(0)
    n, r, c = 24, 7, 4
    logp = _rand_logp(rng, n, r, c)
    tcache = ops.pairwise_kl(torch.from_numpy(logp))
    jcache = jsim.divergence_matrix(jnp.asarray(logp), backend="jnp")
    for step in range(6):
        mask = rng.random(n) < (0.05, 0.2, 0.5)[step % 3]
        mask[rng.integers(n)] = True
        logp = logp.copy()
        logp[mask] = _rand_logp(rng, int(mask.sum()), r, c)
        before = tcache.clone()
        new = sim.update_divergence_cache(tcache, torch.from_numpy(logp),
                                          mask)
        np.testing.assert_array_equal(tcache.numpy(), before.numpy())
        tcache = new
        jcache = jsim.update_divergence_cache(jcache, jnp.asarray(logp),
                                              mask, backend="jnp")
        np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache),
                                   atol=DIV_TOL, rtol=0)
        np.testing.assert_allclose(
            tcache.numpy(), ops.pairwise_kl(torch.from_numpy(logp)).numpy(),
            atol=DIV_TOL, rtol=0)


def test_delta_cache_edge_cases():
    rng = np.random.default_rng(1)
    n = 9
    lp = torch.from_numpy(_rand_logp(rng, n))
    cache = ops.pairwise_kl(lp)
    assert sim.update_divergence_cache(cache, lp, np.zeros(n, bool)) \
        is cache
    full = sim.update_divergence_cache(torch.zeros(n, n), lp,
                                       np.ones(n, bool))
    np.testing.assert_array_equal(full.numpy(), cache.numpy())
    with pytest.raises(TypeError, match="boolean"):
        sim.update_divergence_cache(cache, lp, np.ones(n, np.int32))
    # a torch mask is taken too
    one = torch.zeros(n, dtype=torch.bool)
    one[3] = True
    np.testing.assert_allclose(
        sim.update_divergence_cache(cache, lp, one).numpy(), cache.numpy(),
        atol=DIV_TOL)


def _states(n, r, c, seed):
    rng = np.random.default_rng(seed)
    logp = _rand_logp(rng, n, r, c)
    labels = rng.integers(0, c, r).astype(np.int32)
    up = np.ones(n, bool)
    js = jax_upload(jax_init_server(n, r, c), jnp.asarray(logp),
                    jnp.asarray(up))
    ts = upload_messengers(init_server(n, r, c, device="cpu"),
                           torch.from_numpy(logp), torch.from_numpy(up))
    return rng, js, ts, labels


def _assert_graphs_agree(jg, tg):
    np.testing.assert_array_equal(tg.candidates.numpy(),
                                  np.asarray(jg.candidates))
    np.testing.assert_array_equal(tg.weights.numpy(), np.asarray(jg.weights))
    w = tg.weights.numpy() > 0
    np.testing.assert_array_equal(
        np.where(w.any(1)[:, None], tg.neighbors.numpy(), 0)[w.any(1)],
        np.asarray(jg.neighbors)[w.any(1)])
    np.testing.assert_allclose(tg.similarity.numpy(),
                               np.asarray(jg.similarity), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("selection", ["exact", "ivf"])
def test_delta_policy_rounds_match_reference(selection):
    """Three fires of ``policy_round(..., uploaded=mask)`` in both
    packages: the first ingests every row, the next re-upload a few."""
    n, r, c, q, k = 40, R, C, 24, 4
    rng, js, ts, labels = _states(n, r, c, 2)
    jpol, tpol = jax_as_policy(jax_sqmd(q=q, k=k)), as_policy(sqmd(q=q, k=k))
    jpol.selection = tpol.selection = selection
    mask = np.ones(n, bool)
    for fire in range(3):
        js, jt, jg = jax_policy_round(js, jpol, jnp.asarray(labels),
                                      backend="jnp", uploaded=mask)
        ts, tt, tg = policy_round(ts, tpol, torch.from_numpy(labels),
                                  uploaded=mask)
        _assert_graphs_agree(jg, tg)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
        if selection == "exact":
            np.testing.assert_allclose(ts.div_cache.numpy(),
                                       np.asarray(js.div_cache),
                                       atol=DIV_TOL)
        else:
            assert tg.divergence is None
            assert float(ts.div_cache.abs().sum()) == 0.0   # untouched
            assert tpol._ivf.state_tensors()["codes"].device.type == "cpu"
        mask = rng.random(n) < 0.15
        lp = _rand_logp(rng, int(mask.sum()), r, c)
        full = np.zeros((n, r, c), np.float32)
        full[mask] = lp
        js = jax_upload(js, jnp.asarray(full), jnp.asarray(mask))
        ts = upload_messengers(ts, torch.from_numpy(full),
                               torch.from_numpy(mask))
    with pytest.raises(TypeError):
        policy_round(ts, tpol, torch.from_numpy(labels),
                     uploaded=mask.astype(np.int32))


# --------------------------------------------------------------------------
# the IVF index, probe-all, against a dense int8 oracle
# --------------------------------------------------------------------------

def _oracle_divergence(logp):
    """Dense (n,n) divergence off the SAME int8 round trip the index
    stores — the exact oracle the lists must reproduce."""
    dec = wire.decode(wire.encode("int8", torch.from_numpy(logp)))
    return ref.pairwise_kl_ref(dec).numpy()


def _assert_matches_oracle(idx, logp, active, cand, k):
    div = _oracle_divergence(logp)
    nbrs, ndiv = (t.numpy() for t in idx.select(torch.from_numpy(cand), k))
    for i in np.nonzero(active)[0]:
        ok = active & cand
        ok[i] = False
        want = np.sort(np.where(ok, div[i], np.inf), kind="stable")[:k]
        want = want[np.isfinite(want)]
        got = ndiv[i][np.isfinite(ndiv[i])]
        assert got.size == want.size, (i, got, want)
        np.testing.assert_allclose(got, want, atol=DIV_TOL)
        for a in nbrs[i]:
            if a >= 0:
                assert active[a] and cand[a] and a != i


def _index(n, k, **kw):
    return sim.NeighborIndex(n, R, C, k=k, device="cpu", **kw)


def test_probe_all_matches_oracle_after_uploads():
    rng = np.random.default_rng(0)
    n, k = 48, 4
    idx = _index(n, k, n_probe=PROBE_ALL)
    logp = np.zeros((n, R, C), np.float32)
    active = np.zeros(n, bool)
    for _ in range(8):
        rows = rng.choice(n, size=rng.integers(1, 7), replace=False)
        lp = _rand_logp(rng, rows.size)
        logp[rows] = lp
        active[rows] = True
        idx.update(rows, torch.from_numpy(lp))
    _assert_matches_oracle(idx, logp, active, active.copy(), k)


def test_reupload_changes_lists_exactly():
    """A re-upload must propagate into every OTHER row's list (the
    reverse merge and the degraded-row rebuild)."""
    rng = np.random.default_rng(1)
    n, k = 24, 3
    idx = _index(n, k, n_probe=PROBE_ALL)
    logp = _rand_logp(rng, n)
    active = np.ones(n, bool)
    idx.update(np.arange(n), torch.from_numpy(logp))
    for _ in range(5):
        rows = rng.choice(n, size=3, replace=False)
        lp = _rand_logp(rng, 3)
        logp[rows] = lp
        idx.update(rows, torch.from_numpy(lp))
    _assert_matches_oracle(idx, logp, active, active.copy(), k)


def test_deactivation_never_selected_and_lists_repair():
    rng = np.random.default_rng(2)
    n, k = 32, 4
    idx = _index(n, k, n_probe=PROBE_ALL)
    logp = _rand_logp(rng, n)
    active = np.ones(n, bool)
    idx.update(np.arange(n), torch.from_numpy(logp))
    drop = rng.choice(n, size=8, replace=False)
    active[drop] = False
    idx.sync_active(torch.from_numpy(active))
    nbrs, _ = idx.select(torch.from_numpy(active), k)
    nbrs = nbrs.numpy()
    assert not np.isin(nbrs[nbrs >= 0], drop).any()
    _assert_matches_oracle(idx, logp, active, active.copy(), k)


def test_candidates_ghosts_and_partial_probes():
    """Selections respect the candidate pool and never pick a row that
    was not ingested, under probe-all and under one probe."""
    rng = np.random.default_rng(3)
    n, k = 30, 3
    real = np.arange(0, n, 2)          # odd rows are never ingested
    for probe in (PROBE_ALL, 1):
        idx = _index(n, k, n_probe=probe)
        idx.update(real, torch.from_numpy(_rand_logp(rng, real.size)))
        cand = np.zeros(n, bool)
        cand[: n // 2] = True
        for mask in (np.ones(n, bool), cand):
            nbrs, ndiv = (t.numpy() for t in idx.select(mask, k))
            picked = nbrs[nbrs >= 0]
            assert picked.size > 0
            assert (picked % 2 == 0).all() and mask[picked].all()
            assert (np.isfinite(ndiv) == (nbrs >= 0)).all()
            assert (nbrs != np.arange(n)[:, None]).all()


def test_index_strips_read_the_stored_row_stats(monkeypatch):
    """Every strip the index runs passes the lse it stores: the plain
    version's row-statistics helper is never called through uploads, a
    re-upload wave, a deactivation and a selection repair."""
    from repro_torch.kernels import dequant_kl

    def recompute(*args):
        raise AssertionError("a strip recomputed the row statistics")

    rng = np.random.default_rng(11)
    n, k = 60, 3
    idx = _index(n, k)
    idx.update(np.arange(n), torch.from_numpy(_rand_logp(rng, n)))
    monkeypatch.setattr(dequant_kl, "int8_row_stats", recompute)
    rows = rng.choice(n, 9, replace=False)
    idx.update(rows, torch.from_numpy(_rand_logp(rng, rows.size)))
    active = np.ones(n, bool)
    active[rows[:3]] = False
    idx.sync_active(torch.from_numpy(active))
    cand = active & (rng.random(n) < 0.2)
    nbrs, _ = idx.select(torch.from_numpy(cand))
    assert nbrs.shape == (n, k)


def test_update_dedups_unsorted_rows():
    """Duplicate, unsorted ids keep the payload aligned: the last write
    for an id wins."""
    rng = np.random.default_rng(6)
    idx = _index(12, 2, n_probe=PROBE_ALL)
    lp = _rand_logp(rng, 4)
    idx.update(np.array([7, 3, 7, 1]), torch.from_numpy(lp))
    want = wire.decode(wire.encode("int8", torch.from_numpy(lp[2:3])))[0]
    np.testing.assert_allclose(idx._recon_logp(torch.tensor([7]))[0].numpy(),
                               want.numpy(), atol=1e-5)
    assert idx.active_rows().numpy().sum() == 3


def test_validation_errors():
    with pytest.raises(ValueError):
        _index(0, 2)
    with pytest.raises(ValueError):
        _index(8, 0)
    idx = _index(8, 2)
    with pytest.raises(ValueError):
        idx.update(np.array([8]),
                   torch.from_numpy(_rand_logp(np.random.default_rng(0), 1)))
    with pytest.raises(ValueError):
        idx.select(np.ones(5, bool))
    with pytest.raises(ValueError):
        idx.select(np.ones(8, bool), k=0)
    with pytest.raises(ValueError):
        idx.sync_active(np.ones(5, bool))


# --------------------------------------------------------------------------
# the IVF index against the reference's, default (partial) probes
# --------------------------------------------------------------------------

def test_index_matches_reference_with_default_probes():
    """The same upload / re-upload / deactivation sequence through both
    indexes, with a quantizer refit on the way: equal assignments, list
    ids, degraded counts and selections; divergences to 1e-5."""
    rng = np.random.default_rng(10)
    n, k = 300, 4
    jidx = jsim.NeighborIndex(n, R, C, k=k, backend="jnp")
    tidx = _index(n, k)
    steps = [np.arange(20), np.arange(20, 90),
             rng.choice(90, 15, replace=False), np.arange(90, 300),
             rng.choice(300, 7, replace=False)]
    for rows in steps:
        lp = _rand_logp(rng, rows.size)
        assert tidx.update(rows, torch.from_numpy(lp)) \
            == jidx.update(rows, lp)
        assert tidx.n_centroids == jidx.n_centroids
        assert tidx._effective_probe() == jidx._effective_probe()
    assert tidx.n_centroids == 9 and tidx._effective_probe() == 3
    active = np.ones(n, bool)
    active[rng.choice(n, 20, replace=False)] = False
    jidx.sync_active(active)
    tidx.sync_active(torch.from_numpy(active))
    np.testing.assert_array_equal(tidx._assign.numpy(), jidx._assign)
    np.testing.assert_array_equal(tidx._list_ids.numpy(), jidx._list_ids)
    fin = np.isfinite(jidx._list_div)
    np.testing.assert_array_equal(np.isfinite(tidx._list_div.numpy()), fin)
    np.testing.assert_allclose(tidx._list_div.numpy()[fin],
                               jidx._list_div[fin], atol=DIV_TOL)
    np.testing.assert_allclose(tidx._centroids.numpy(), jidx._centroids,
                               atol=1e-5)
    assert tidx.bytes_resident() == jidx.bytes_resident()
    cand = active.copy()
    cand[rng.choice(n, 150, replace=False)] = False
    jn, jd = jidx.select(cand)
    tn, td = tidx.select(torch.from_numpy(cand))
    np.testing.assert_array_equal(tn.numpy(), jn)
    np.testing.assert_array_equal(np.isfinite(td.numpy()), np.isfinite(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td.numpy()[fin], jd[fin], atol=DIV_TOL)
