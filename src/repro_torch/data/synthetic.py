"""Synthetic datasets with the papers' statistical structure (no
PhysioNet download). A numpy-only copy of the reference generators, so
the same seed gives the same data in both packages.

Three generators mirror Table I:

  sc_like     — 3-class EEG-sleep-stage-like time series, 32 clients whose
                class priors AND feature dynamics cluster into latent
                sub-populations (the non-IID structure that makes I-SGD beat
                FedMD on SC in the paper).
  pad_like    — 2-class apnea/RR-interval-like 60-dim series, 28 clients,
                severity clusters (severe / moderate / normal recordings).
  fmnist_like — 10-class IID feature vectors split evenly into 20 clients,
                then ONE random class removed per client (paper §IV-B).

Each sample is a (L,) float series (or flat feature vector) + int label.
Client clustering is what SQMD's similarity graph is supposed to discover.

``lm_token_stream`` makes the LM trainer's token stream (torch: the
reference draws it with threefry, so the tests carry its stream across).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch import Device, resolve_device


@dataclasses.dataclass
class FederatedDataset:
    name: str
    n_classes: int
    feature_len: int
    # per-client private shards
    client_x: List[np.ndarray]            # each (M_n, L)
    client_y: List[np.ndarray]            # each (M_n,)
    # the preloaded reference set + server-held labels (Def. 1)
    ref_x: np.ndarray                     # (R, L)
    ref_y: np.ndarray                     # (R,)
    # ground-truth latent cluster of every client (for analysis only)
    client_cluster: np.ndarray            # (N,)

    @property
    def n_clients(self) -> int:
        return len(self.client_x)


def _gen_class_series(rng: np.random.Generator, n: int, length: int,
                      cls: int, cluster: int, n_classes: int,
                      conflict: bool = True) -> np.ndarray:
    """Each (class, cluster) maps to a waveform "pattern".

    With ``conflict=True`` the pattern index is (cls + cluster): adjacent
    clusters REUSE each other's patterns under different labels — the
    paper's §IV-E thought experiment (pattern X means class 1 in cluster 0
    but class 0 in cluster 1). Global messenger averaging is then actively
    misleading across clusters, while within-cluster collaboration is
    consistent: exactly the regime where SQMD's similarity graph matters."""
    t = np.linspace(0, 4 * np.pi, length)[None, :]
    pattern = (cls + cluster) if conflict else (cls + 0.2 * cluster)
    freq = 1.0 + pattern * 0.7
    phase = rng.uniform(0, 2 * np.pi, (n, 1))
    x = (np.sin(freq * t + phase)
         + 0.3 * np.sin(2.3 * freq * t + 1.7 * phase)
         + rng.normal(0, 0.8, (n, length)))
    return x.astype(np.float32)


def _clustered_dataset(name: str, seed: int, n_clients: int, n_classes: int,
                       n_clusters: int, length: int, samples_per_client: int,
                       ref_size: int, skew: float) -> FederatedDataset:
    rng = np.random.default_rng(seed)
    client_cluster = np.array([i % n_clusters for i in range(n_clients)])
    rng.shuffle(client_cluster)
    client_x, client_y = [], []
    for n in range(n_clients):
        cl = int(client_cluster[n])
        # cluster-dependent class prior (Dirichlet skew); skew=0 -> IID
        if skew == 0.0:
            prior = np.full(n_classes, 1.0 / n_classes)
        else:
            alpha = np.ones(n_classes)
            alpha[cl % n_classes] += skew
            prior = rng.dirichlet(alpha)
        ys = rng.choice(n_classes, samples_per_client, p=prior)
        xs = np.concatenate([
            _gen_class_series(rng, int((ys == c).sum()), length, c, cl,
                              n_classes)
            for c in range(n_classes)], axis=0)
        order = np.argsort(np.concatenate(
            [np.where(ys == c)[0] for c in range(n_classes)]))
        ys_sorted = np.concatenate([ys[ys == c] for c in range(n_classes)])
        perm = rng.permutation(samples_per_client)
        client_x.append(xs[perm])
        client_y.append(ys_sorted[perm])
    # reference set: cluster-balanced mix (paper: 20% of slices combined)
    per = max(1, ref_size // (n_classes * n_clusters))
    rx, ry = [], []
    for cl in range(n_clusters):
        for c in range(n_classes):
            rx.append(_gen_class_series(rng, per, length, c, cl, n_classes))
            ry.append(np.full(per, c))
    ref_x = np.concatenate(rx)
    ref_y = np.concatenate(ry).astype(np.int32)
    perm = rng.permutation(len(ref_y))
    return FederatedDataset(name, n_classes, length, client_x, client_y,
                            ref_x[perm], ref_y[perm], client_cluster)


def sc_like(seed: int = 0, samples_per_client: int = 400,
            ref_size: int = 240, length: int = 64) -> FederatedDataset:
    """Sleep-Cassette-like: 32 clients, 3 classes (awake/NREM/REM),
    4 latent sub-populations with strong class skew."""
    return _clustered_dataset("sc_like", seed, 32, 3, 4, length,
                              samples_per_client, ref_size, skew=6.0)


def pad_like(seed: int = 1, samples_per_client: int = 400,
             ref_size: int = 200, length: int = 60) -> FederatedDataset:
    """Apnea-ECG-like: 28 clients, 2 classes (apnea/normal), 3 severity
    clusters (severe patients mostly-positive, normals mostly-negative)."""
    return _clustered_dataset("pad_like", seed, 28, 2, 3, length,
                              samples_per_client, ref_size, skew=8.0)


def fmnist_like(seed: int = 2, samples_per_client: int = 500,
                ref_size: int = 400, length: int = 96) -> FederatedDataset:
    """FMNIST-like: 20 clients, 10 classes, near-IID, one random class
    REMOVED from each client's shard (paper §IV-B)."""
    ds = _clustered_dataset("fmnist_like", seed, 20, 10, 1, length,
                            samples_per_client + 100, ref_size, skew=0.0)
    rng = np.random.default_rng(seed + 77)
    for n in range(ds.n_clients):
        drop = rng.integers(0, 10)
        keep = ds.client_y[n] != drop
        ds.client_x[n] = ds.client_x[n][keep][:samples_per_client]
        ds.client_y[n] = ds.client_y[n][keep][:samples_per_client]
    return ds


DATASETS = {"sc_like": sc_like, "pad_like": pad_like,
            "fmnist_like": fmnist_like}


# ---------------------------------------------------------------------------
# LM token streams (for the LM trainer)
# ---------------------------------------------------------------------------

def lm_token_stream(vocab_size: int, n_tokens: int,
                    generator: Optional[torch.Generator] = None,
                    device: Device = None) -> torch.Tensor:
    """A synthetic Zipf-ish Markov token stream (int32, on ``device``;
    None: the card): the reference's construction, so a real LM learns
    it (loss drops well below ln V) without a corpus on disk. Each token
    is drawn from the Zipf prior p(r) ~ 1/r (inverse CDF, as
    ``jax.random.choice`` draws) or, with probability 1/2, is the
    deterministic mix ``(31 t[i-1] + 7 t[i-2]) mod V`` of the two draws
    before it (rolled around the start). ``generator`` must live on the
    device."""
    dev = resolve_device(device)
    ranks = torch.arange(1, vocab_size + 1, dtype=torch.float32, device=dev)
    probs = 1.0 / ranks
    cdf = torch.cumsum(probs / probs.sum(), dim=0)
    u = torch.rand(n_tokens, generator=generator, device=dev)
    base = torch.searchsorted(cdf, cdf[-1] * (1.0 - u)).clamp_(
        max=vocab_size - 1)
    shifted = torch.roll(base, 1) * 31 + torch.roll(base, 2) * 7
    mix = torch.rand(n_tokens, generator=generator, device=dev) < 0.5
    return torch.where(mix, shifted % vocab_size, base).to(torch.int32)
