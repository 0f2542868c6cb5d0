"""Client-axis sharding on the card (``gpu``-marked: skips without an
sm_90 card). The meshes repeat the one card (the engines' ``mesh=``
seam), so every shard runs there. This file imports no JAX:

    PYTHONPATH=src python -m pytest -m gpu --noconftest \
        tests/test_torch_gpu_sharding.py

The 8-shard Eq. 2 rebuild is held within 1e-6 of the unsharded one with
the same neighbors; the 8-shard sync and async federations within 1e-6
of the unsharded card runs, their ghost rows unchanged bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (AsyncFederationEngine, FederationConfig,
                              FederationEngine, Quorum, StragglerLatency,
                              candidate_mask, select_neighbors_from_div,
                              sqmd)
from repro_torch.convert import tensors_to_numpy
from repro_torch.core.similarity import divergence_matrix
from repro_torch.data import make_splits, pad_like
from repro_torch.kernels import ops
from repro_torch.models import hetero_mlp_zoo
from repro_torch.optim import state_tensors
from repro_torch.sharding import ClientMesh

SHARD_TOL = 1e-6
CFG = dict(rounds=4, batch_size=8, eval_every=2)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 card (kernels build for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1000, 4096])
def test_sharded_rebuild_on_card_matches_unsharded(hopper, n):
    rng = np.random.default_rng(0)
    z = rng.normal(size=(n, 240, 10)) * 2
    lp = torch.from_numpy((z - np.log(np.exp(z).sum(-1, keepdims=True)))
                          .astype(np.float32)).to(hopper)
    whole = ops.pairwise_kl(lp)
    quality = ops.soft_ce(lp, torch.from_numpy(
        rng.integers(0, 10, 240).astype(np.int32)).to(hopper))
    cand = candidate_mask(quality, torch.ones(n, dtype=torch.bool,
                                              device=hopper), 64)
    ops.reset_launch_counts()
    div = divergence_matrix(lp, mesh=ClientMesh((hopper,) * 8))
    assert ops.launch_counts()["pairwise_kl_pair"] == 8
    assert div.shape == (n, n) and div.is_cuda
    assert float((div - whole).abs().max()) <= SHARD_TOL
    assert torch.equal(select_neighbors_from_div(div, cand, 8).neighbors,
                       select_neighbors_from_div(whole, cand, 8).neighbors)


def _run(device, asynchronous, shards):
    ds = pad_like(samples_per_client=30, ref_size=30, length=24)
    splits = make_splits(ds, seed=0)
    zoo = hetero_mlp_zoo(ds.feature_len, ds.n_classes)
    names = list(zoo)
    rng = np.random.default_rng(2)
    init, sizes = {}, []
    for fam, cfg in zoo.items():
        ids = [i for i in range(ds.n_clients) if names[i % 3] == fam]
        init[fam] = {"layers": [
            {"w": rng.normal(size=(len(ids), a, b)).astype(np.float32)
             / np.float32(np.sqrt(a)),
             "b": np.zeros((len(ids), b), np.float32)}
            for a, b in zip(cfg.dims[:-1], cfg.dims[1:])]}
        sizes.append((len(ids), len(splits[ids[0]].train_y)))
    common = dict(
        config=FederationConfig(**CFG, devices=shards), seed=7,
        device=device, init_params=init,
        mesh=None if shards is None else ClientMesh((device,) * shards),
        batch_indices=lambda step, ci: np.random.default_rng(
            (3, step, ci)).integers(0, sizes[ci][1], (sizes[ci][0], 8)))
    if asynchronous:
        eng = AsyncFederationEngine.build(
            ds, splits, zoo, None, sqmd(q=8, k=4),
            arrivals=StragglerLatency(fraction=0.5, delay=2.0, seed=1),
            trigger=Quorum(frac=0.5), **common)
        hist = eng.fit(splits, until=4.0)
    else:
        eng = FederationEngine.build(ds, splits, zoo, None, sqmd(q=8, k=4),
                                     **common)
        hist = eng.fit(splits)
    return eng, hist, init


@pytest.mark.gpu
@pytest.mark.parametrize("asynchronous", [False, True])
def test_sharded_federation_on_card_matches_unsharded(hopper, asynchronous):
    ops.reset_launch_counts()
    e8, h8, init = _run(hopper, asynchronous, 8)
    counts = ops.launch_counts()
    assert counts["pairwise_kl_pair"] > 0 and counts["soft_ce"] > 0
    e1, h1, _ = _run(hopper, asynchronous, None)
    np.testing.assert_allclose(h8.mean_acc, h1.mean_acc, rtol=0,
                               atol=SHARD_TOL)
    np.testing.assert_allclose(h8.val_acc, h1.val_acc, rtol=0,
                               atol=SHARD_TOL)
    assert h8.bytes_up == h1.bytes_up
    assert h8.server_rounds == h1.server_rounds
    assert float((e8.server.repo_logp - e1.server.repo_logp).abs().max()) \
        <= SHARD_TOL
    # every ghost row still holds its last real client's initial params
    # and a zero optimizer state
    ghosts = 0
    for coh in e8.fed.cohorts:
        assert coh.n_pad > 0 and len(coh.shards) == 8
        for sh in coh.shards:
            real = coh.real_rows(sh)
            ghosts += sh.n_rows - real
            got = tensors_to_numpy(coh.module,
                                   [p[real:] for p in sh.model.parameters()])
            for layer, want in zip(got["layers"],
                                   init[coh.family_name]["layers"]):
                for key in ("w", "b"):
                    np.testing.assert_array_equal(layer[key], np.broadcast_to(
                        want[key][-1], layer[key].shape))
            for t in state_tensors(sh.opt_state):
                assert t.is_cuda and bool((t[real:] == 0).all())
    assert ghosts > 0
