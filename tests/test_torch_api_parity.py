"""The port's small API surfaces against the reference's, one cheap case
each:

  * the sync engine's leftovers: ``FederationEngine.add_callback`` (also
    on the async engine), ``Federation.client_rows`` and
    ``policies.unregister_policy``;
  * the data and metric helpers the paper's benchmark drivers use:
    ``make_splits(sparsity_r=, label_noise=)``, ``fmnist_like`` and
    ``precision_recall``, array for array on the same numpy seeds, and
    the metric on the same params.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import core as J
from repro import data as JD
from repro.core import policies as JP
from repro.models.mlp import hetero_mlp_zoo as jax_zoo
from repro_torch import core as T
from repro_torch import data as TD
from repro_torch.convert import cohort_params_to_numpy
from repro_torch.core import policies as TP
from repro_torch.models import hetero_mlp_zoo

DS = dict(samples_per_client=12, ref_size=6, length=8)
CFG = dict(rounds=2, batch_size=4, eval_every=1)


@pytest.fixture(scope="module")
def engine():
    """A tiny port federation (no round run) on the CPU. The reference's
    functions are held to it through stand-ins carrying its cohorts'
    client ids, apply functions and params (a reference engine's build
    compiles its inits for ~10 s)."""
    ds = TD.pad_like(**DS)
    splits = TD.make_splits(ds, seed=1, sparsity_r=50.0)
    zoo = hetero_mlp_zoo(ds.feature_len, ds.n_classes)
    assignment = [list(zoo)[i % 3] for i in range(ds.n_clients)]
    eng = T.FederationEngine.build(ds, splits, zoo, assignment,
                                   T.sqmd(q=4, k=2),
                                   config=T.FederationConfig(**CFG),
                                   seed=5, device="cpu")
    return dict(eng=eng, splits=splits, n_classes=ds.n_classes,
                feature_len=ds.feature_len)


def test_client_rows_match_reference(engine):
    fed = engine["eng"].fed
    assert len(fed.cohorts) == 3
    for coh in fed.cohorts:
        stand_in = types.SimpleNamespace(client_ids=coh.client_ids.copy())
        np.testing.assert_array_equal(
            fed.client_rows(coh), J.Federation.client_rows(None, stand_in))


def test_precision_recall_matches_reference(engine):
    """Macro precision and recall over every client's (sparsified,
    unequal) test shard: the reference's function on the port cohorts'
    params exported to its layout, against the port's."""
    fed = engine["eng"].fed
    zoo = jax_zoo(engine["feature_len"], engine["n_classes"])
    ref = types.SimpleNamespace(cohorts=[types.SimpleNamespace(
        client_ids=coh.client_ids, apply_fn=zoo[coh.family_name][1],
        params=jax.tree.map(jnp.asarray, cohort_params_to_numpy(
            coh.shards[0].model))) for coh in fed.cohorts])
    want = J.precision_recall(ref, engine["splits"], engine["n_classes"])
    got = T.precision_recall(fed, engine["splits"], engine["n_classes"])
    assert got == pytest.approx(want, abs=1e-12)


def test_add_callback_runs_after_the_constructed_ones(engine):
    """The reference appends to ``callbacks``, and both engines bind the
    sync engine's method; the port's fit then calls the added callback
    after the constructed ones at every evaluation."""
    assert J.AsyncFederationEngine.add_callback is \
        J.FederationEngine.add_callback
    assert T.AsyncFederationEngine.add_callback is \
        T.FederationEngine.add_callback
    first, added = (lambda *a: None), (lambda *a: None)
    lists = []
    for eng_cls in (J.FederationEngine, T.FederationEngine):
        stand_in = types.SimpleNamespace(callbacks=[first])
        eng_cls.add_callback(stand_in, added)
        lists.append(stand_in.callbacks)
    assert lists[0] == lists[1] == [first, added]
    teng = engine["eng"]
    calls = []
    teng.callbacks = [lambda e, rnd, m: calls.append(("built", rnd))]
    teng.add_callback(lambda e, rnd, m: calls.append(
        ("added", rnd, e is teng, m["round"] == rnd)))
    teng.fit(engine["splits"])
    assert calls == [("built", 0), ("added", 0, True, True),
                     ("built", 1), ("added", 1, True, True)]


def test_unregister_policy_matches_reference():
    seen = []
    for pkg in (JP, TP):
        @pkg.register_policy("toy-unregister")
        class Toy(pkg.ServerPolicy):
            pass
        seen.append(pkg.is_registered("toy-unregister"))
        pkg.unregister_policy("toy-unregister")
        seen.append(pkg.is_registered("toy-unregister"))
        pkg.unregister_policy("toy-unregister")      # unknown: a no-op
        with pytest.raises(KeyError):
            pkg.get_policy("toy-unregister")
    assert seen == [True, False, True, False]


@pytest.mark.parametrize("r,noise", [(25.0, 0.35), (5.0, 0.2)])
def test_make_splits_sparsity_and_label_noise_match_reference(r, noise):
    jds, tds = JD.sc_like(**DS), TD.sc_like(**DS)
    js = JD.make_splits(jds, seed=4, sparsity_r=r, label_noise=noise)
    ts = TD.make_splits(tds, seed=4, sparsity_r=r, label_noise=noise)
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        for f in ("train_x", "train_y", "val_x", "val_y", "test_x",
                  "test_y"):
            np.testing.assert_array_equal(np.asarray(getattr(b, f)),
                                          np.asarray(getattr(a, f)))


def test_fmnist_like_matches_reference():
    jds, tds = JD.fmnist_like(seed=3, **DS), TD.fmnist_like(seed=3, **DS)
    assert (tds.n_clients, tds.n_classes) == (jds.n_clients, jds.n_classes)
    for f in ("ref_x", "ref_y"):
        np.testing.assert_array_equal(getattr(tds, f), getattr(jds, f))
    for a, b in zip(jds.client_x, tds.client_x):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jds.client_y, tds.client_y):
        np.testing.assert_array_equal(b, a)
