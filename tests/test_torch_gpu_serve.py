"""Train-and-serve and checkpoints on the card (``gpu``-marked: skips
without an sm_90 card). This file imports no JAX, so it also runs where
only the port is installed:

    PYTHONPATH=src python -m pytest -m gpu --noconftest \
        tests/test_torch_gpu_serve.py

The serving run on the card must keep the CPU run's records field for
field (logits within 1e-3), answer with the bit pattern of the same
forward on the snapshot's params, and launch B1, B2 and the gather on
its server fires. A card run saved, restored into an engine of other
weights and continued equals the uninterrupted card run bit for bit; a
file without ``div_cache`` has it rebuilt on B1.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (restore_federation, restore_pytree,
                                    save_federation, save_pytree)
from repro_torch.convert import numpy_cohort_inputs
from repro_torch.core import (AsyncFederationEngine, FederationConfig,
                              FederationEngine, HeterogeneousCadence,
                              EveryKUploads, sqmd)
from repro_torch.data import make_splits, pad_like
from repro_torch.kernels import ops, ref
from repro_torch.models import hetero_mlp_zoo
from repro_torch.models.mlp import mlp_family
from repro_torch.serve import (PoissonQueries, QueryRuntime, serve_step,
                               split_query_stream)

PATH = ("pairwise_kl_split", "pairwise_kl_pair", "soft_ce",
        "neighbor_gather")
KEYS = ("seq", "client_id", "t_arrival", "t_served", "version",
        "staleness", "batch_size", "buckets", "depth_at_admission")


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 card (kernels build for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs():
    ds = pad_like(samples_per_client=30, ref_size=30, length=24)
    splits = make_splits(ds, seed=0)
    zoo = hetero_mlp_zoo(ds.feature_len, ds.n_classes)
    builders = {k: mlp_family(v) for k, v in zoo.items()}
    names = list(zoo)
    assignment = [names[i % 3] for i in range(ds.n_clients)]
    init, draws = numpy_cohort_inputs(builders, assignment, splits, 8, 2)
    return ds, splits, zoo, init, draws


def _serve(device):
    ds, splits, zoo, init, draws = _inputs()
    eng = AsyncFederationEngine.build(
        ds, splits, zoo, None, sqmd(q=8, k=4),
        arrivals=HeterogeneousCadence(fast=1.0, slow=2.5, seed=4),
        trigger=EveryKUploads(k=10),
        config=FederationConfig(batch_size=8, eval_every=2), seed=7,
        device=device, init_params=init, batch_indices=draws)
    qr = QueryRuntime(eng, workload=PoissonQueries(rate=0.6, seed=2),
                      policy="micro:8", features=split_query_stream(splits))
    logits = []
    serve = qr.qengine.serve

    def keeping(*a, **kw):
        res = serve(*a, **kw)
        logits.append(res.logits)
        return res

    qr.qengine.serve = keeping
    qr.run(splits, until=4.0)
    return qr, logits, splits


@pytest.mark.gpu
def test_serving_on_the_card_matches_cpu(hopper):
    ops.reset_launch_counts()
    card, card_logits, splits = _serve(hopper)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in PATH), counts
    cpu, cpu_logits, _ = _serve("cpu")
    assert len(card.records) == len(cpu.records) > 20
    for a, b in zip(card.records, cpu.records):
        for key in KEYS:
            assert a[key] == b[key], key
    for a, b in zip(card_logits, cpu_logits):
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
    snap = card.store.current()
    assert all(p.is_cuda for v in snap.views for p in v.params.values())
    # the same forward on the same padded bucket of 4, to the bit
    view = snap.views[0]
    xs = np.stack([splits[c].test_x[0] for c in (0, 3, 6)])
    res = card.qengine.serve([0, 3, 6], xs, t=4.0, snapshot=snap)
    assert res.buckets == (4,)
    rows = np.append(snap.row_of[[0, 3, 6]], 0)
    want = serve_step(view.module, view.params,
                      torch.as_tensor(rows, device=hopper),
                      torch.from_numpy(np.concatenate(
                          [xs, np.zeros_like(xs[:1])])).to(hopper))[:3]
    np.testing.assert_array_equal(res.logits, want.cpu().numpy())


def _sync(device, seed, init=None, draws=None):
    ds, splits, zoo, *_ = _inputs()
    return FederationEngine.build(
        ds, splits, zoo, None, sqmd(q=8, k=4),
        config=FederationConfig(rounds=5, batch_size=8), seed=seed,
        device=device, init_params=init, batch_indices=draws)


@pytest.mark.gpu
def test_resume_on_the_card_is_bit_exact(hopper, tmp_path):
    _, _, _, init, draws = _inputs()
    oracle = _sync(hopper, 1, init, draws)
    first = _sync(hopper, 1, init, draws)
    for rnd in range(5):
        oracle.run_round(rnd)
    for rnd in range(2):
        first.run_round(rnd)
    save_federation(str(tmp_path), first.fed, step=2, bus=first.bus,
                    clients=first.clients)
    resumed = _sync(hopper, 9, None, draws)          # other weights
    restore_federation(str(tmp_path), resumed.fed, bus=resumed.bus,
                       clients=resumed.clients)
    for rnd in range(2, 5):
        resumed.run_round(rnd)
    for a, b in zip(oracle.fed.cohorts, resumed.fed.cohorts):
        for p, q in zip(a.model.parameters(), b.model.parameters()):
            assert q.is_cuda and torch.equal(p, q)
    for a, b in zip(oracle.server, resumed.server):
        assert b.is_cuda and torch.equal(a, b)
    assert torch.equal(oracle.fed.targets, resumed.fed.targets)


@pytest.mark.gpu
def test_legacy_restore_rebuilds_div_cache_on_b1(hopper, tmp_path):
    eng = _sync(hopper, 1)
    for rnd in range(2):
        eng.run_round(rnd)
    save_federation(str(tmp_path / "a"), eng.fed, step=2)
    tree = restore_pytree(str(tmp_path / "a" / "step_2.msgpack"))
    del tree["server"]["div_cache"]
    save_pytree(str(tmp_path / "b" / "step_2.msgpack"), tree)
    fresh = _sync(hopper, 3)
    ops.reset_launch_counts()
    restore_federation(str(tmp_path / "b"), fresh.fed)
    torch.cuda.synchronize()
    assert ops.launch_counts()["pairwise_kl_pair"] > 0
    lp = fresh.server.repo_logp
    want = ref.pairwise_kl_pair_ref(lp, lp)
    torch.testing.assert_close(fresh.server.div_cache, want, atol=1e-4,
                               rtol=1e-4)
