"""The asynchronous federation on the card against the same run on the
CPU (``gpu``-marked: skips without an sm_90 card). This file imports no
JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m gpu --noconftest \
        tests/test_torch_gpu_async.py

Both runs get the same numpy-made weights and batch draws; the History
bookkeeping must be equal and the eval logits within 1e-3, and the
card's run must launch the kernels of its path.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (AsyncFederationEngine, BurstyArrivals,
                              EveryKUploads, FederationConfig, Quorum,
                              StragglerLatency, sqmd)
from repro_torch.data import make_splits, pad_like
from repro_torch.kernels import ops
from repro_torch.models import hetero_mlp_zoo

REGIMES = {
    "straggler-quorum-delta": (
        lambda: StragglerLatency(fraction=0.3, delay=2.5, seed=1),
        lambda: Quorum(frac=0.5), dict(delta_graph=True),
        ("pairwise_kl_split", "pairwise_kl_pair", "soft_ce",
         "neighbor_gather")),
    "bursty-every-k-ivf-int8": (
        lambda: BurstyArrivals(burst_every=2.0, frac=0.5, jitter=0.8,
                               seed=2),
        lambda: EveryKUploads(k=6),
        dict(delta_graph=True, selection="ivf", uplink="int8"),
        ("soft_ce", "neighbor_gather", "int8_pairwise_kl_thin")),
}


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 card (kernels build for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run(device, regime, logits):
    arrivals, trigger, server, _ = REGIMES[regime]
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

    def record(engine, rnd, metrics):
        out = []
        for coh in engine.fed.cohorts:
            xs = torch.from_numpy(np.stack(
                [splits[i].test_x for i in coh.client_ids])).to(device)
            with torch.no_grad():
                out.append(coh.model(xs).cpu().numpy())
        logits.append(out)

    eng = AsyncFederationEngine.build(
        ds, splits, zoo, None, sqmd(q=8, k=4), arrivals=arrivals(),
        trigger=trigger(), config=FederationConfig(
            batch_size=8, local_steps=2, eval_every=2, **server),
        seed=7, callbacks=[record], device=device, init_params=init,
        batch_indices=lambda step, ci: np.random.default_rng(
            (3, step, ci)).integers(0, sizes[ci][1], (sizes[ci][0], 8)))
    return eng, eng.fit(splits, until=6.0)


@pytest.mark.gpu
@pytest.mark.parametrize("regime", list(REGIMES))
def test_async_federation_on_the_card_matches_cpu(hopper, regime):
    card_logits, cpu_logits = [], []
    ops.reset_launch_counts()
    eng, hist = _run(hopper, regime, card_logits)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in REGIMES[regime][3]), counts
    assert eng.fed.targets.is_cuda and all(t.is_cuda for t in eng.server)
    _, cpu_hist = _run("cpu", regime, cpu_logits)
    for key in ("rounds", "times", "server_rounds", "staleness",
                "bytes_up", "bytes_down"):
        assert getattr(hist, key) == getattr(cpu_hist, key), key
    assert len(card_logits) == len(cpu_logits) == 4
    for g, c in zip(card_logits, cpu_logits):
        for a, b in zip(g, c):
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
