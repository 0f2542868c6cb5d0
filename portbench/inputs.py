"""Everything a run feeds the port and the reference, made from ``--seed``.

* Data: a frozen copy of the shapes of the port's synthetic sets
  (``fmnist_like``, ``sc_like``): clients in latent clusters, a class
  prior per client (Dirichlet-skewed towards its cluster's class, or
  uniform with one class removed), and series ``sin(f t + phi) + 0.3
  sin(2.3 f t + 1.7 phi) + noise`` whose frequency ``f = 1 + 0.7 (class +
  cluster)`` makes the same pattern mean different classes in adjacent
  clusters. Only the training share of each client is made: the
  benchmark never evaluates. Series are drawn on the device from a
  ``torch.Generator``, a block of clients at a time, and handed over as
  numpy, which is what the port's entry point takes.
* Weights: each family's leaves, drawn on the device in one call a
  family and kept on the host.
* Batch draws: (client, sample) indices per local step and cohort, from
  numpy's Philox keyed by (seed, step, cohort).
* Availability: the traffic mix's draw per round (``availability``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench import availability, spec

DATA_BLOCK = 1024           # clients drawn on the device at once
SEED_MOD = 2 ** 63


@dataclasses.dataclass
class Inputs:
    seed: int
    config: dict
    traffic: dict
    x: np.ndarray                    # (N, M, L) float32, training series
    y: np.ndarray                    # (N, M) int64
    ref_x: np.ndarray                # (R, L) float32
    ref_y: np.ndarray                # (R,) int64
    cluster: np.ndarray              # (N,)
    assignment: List[str]            # family name per client
    cohorts: List[Tuple[dict, np.ndarray]]   # (family, client ids), in
    # the order the port builds them
    weights: Dict[str, Dict[str, torch.Tensor]]   # family -> leaf -> host

    @property
    def n_clients(self) -> int:
        return self.x.shape[0]

    @property
    def n_classes(self) -> int:
        return int(self.config["task"]["n_classes"])

    @property
    def in_dim(self) -> int:
        return int(self.x.shape[2])

    def available(self, rnd: int) -> np.ndarray:
        return availability.mask(self.traffic, self.seed, rnd,
                                 self.n_clients)

    def draws(self, step: int, ci: int) -> np.ndarray:
        """(n_c, B) sample indices of cohort ``ci`` at local step
        ``step``."""
        n_c = len(self.cohorts[ci][1])
        rng = np.random.default_rng([self.seed % SEED_MOD, 7, step, ci])
        return rng.integers(0, self.x.shape[1],
                            (n_c, int(self.config["batch_size"])))


def train_samples(task: dict) -> int:
    return int(task["samples_per_client"] * task["train_share"])


def _priors(task: dict, n: int, rng: np.random.Generator
            ) -> Tuple[np.ndarray, np.ndarray]:
    c, k = int(task["n_classes"]), int(task["n_clusters"])
    cluster = np.arange(n) % k
    rng.shuffle(cluster)
    if task["skew"] == 0.0:
        prior = np.full((n, c), 1.0 / c)
    else:
        alpha = np.ones((n, c))
        alpha[np.arange(n), cluster % c] += task["skew"]
        g = rng.gamma(alpha)
        prior = g / g.sum(axis=1, keepdims=True)
    if task.get("drop_one_class"):
        prior[np.arange(n), rng.integers(0, c, n)] = 0.0
        prior /= prior.sum(axis=1, keepdims=True)
    return cluster, prior


def _series(pattern: torch.Tensor, length: int, noise: float,
            gen: torch.Generator) -> torch.Tensor:
    """(…,) patterns -> (…, length) series."""
    dev = pattern.device
    t = torch.linspace(0, 4 * math.pi, length, device=dev)
    freq = (1.0 + 0.7 * pattern.float())[..., None]
    phase = torch.rand(pattern.shape + (1,), generator=gen,
                       device=dev) * (2 * math.pi)
    x = torch.sin(freq * t + phase) + 0.3 * torch.sin(2.3 * freq * t
                                                      + 1.7 * phase)
    return x + noise * torch.randn(x.shape, generator=gen, device=dev)


def make_data(task: dict, n: int, seed: int, device
              ) -> Tuple[np.ndarray, ...]:
    """(x (N, M, L), y (N, M), ref_x (R, L), ref_y (R,), cluster (N,))."""
    rng = np.random.default_rng([seed % SEED_MOD, 1])
    cluster, prior = _priors(task, n, rng)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2 ** 62)))
    m, length = train_samples(task), int(task["length"])
    x = np.empty((n, m, length), np.float32)
    y = np.empty((n, m), np.int64)
    for i in range(0, n, DATA_BLOCK):
        p = torch.as_tensor(prior[i:i + DATA_BLOCK], dtype=torch.float32,
                            device=device)
        yb = torch.multinomial(p, m, replacement=True, generator=gen)
        cl = torch.as_tensor(cluster[i:i + DATA_BLOCK], device=device)
        xb = _series(yb + cl[:, None], length, task["noise"], gen)
        x[i:i + DATA_BLOCK] = xb.cpu().numpy()
        y[i:i + DATA_BLOCK] = yb.cpu().numpy()
    c, k = int(task["n_classes"]), int(task["n_clusters"])
    per = max(1, int(task["ref_size"]) // (c * k))
    ref_cls = torch.arange(c, device=device).repeat(k).repeat_interleave(per)
    ref_cl = torch.arange(k, device=device).repeat_interleave(c * per)
    ref_x = _series(ref_cls + ref_cl, length, task["noise"], gen)
    perm = torch.randperm(len(ref_cls), generator=gen, device=device)
    return (x, y, ref_x[perm].cpu().numpy(),
            ref_cls[perm].cpu().numpy().astype(np.int64), cluster)


def make_weights(kind_mod, fam: dict, n_c: int, in_dim: int,
                 n_classes: int, gen: torch.Generator
                 ) -> Dict[str, torch.Tensor]:
    """A family's stacked leaves: the normal ones from one device draw,
    then kept on the host."""
    specs = kind_mod.param_specs(fam, in_dim, n_classes)
    sizes = [n_c * math.prod(shape) for _, shape, init in specs
             if init[0] == "normal"]
    flat = torch.randn(sum(sizes), generator=gen, device=gen.device)
    out, at = {}, 0
    for name, shape, (init, value) in specs:
        if init == "normal":
            size = n_c * math.prod(shape)
            leaf = flat[at:at + size].reshape((n_c,) + tuple(shape)) * value
            at += size
        else:
            leaf = torch.full((n_c,) + tuple(shape), float(value),
                              device=gen.device)
        out[name] = leaf.cpu()
    return out


def assign(families: Sequence[dict], n: int) -> List[str]:
    """Round-robin over the families, in the configuration's order."""
    return [families[i % len(families)]["name"] for i in range(n)]


def make_inputs(config: dict, traffic: dict, seed: int, device,
                root=spec.ROOT) -> Inputs:
    n = int(config["n_clients"])
    x, y, ref_x, ref_y, cluster = make_data(config["task"], n, seed, device)
    names = assign(config["families"], n)
    cohorts = []
    for fam in config["families"]:
        ids = np.array([i for i in range(n) if names[i] == fam["name"]])
        if len(ids):
            cohorts.append((fam, ids))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.default_rng([seed % SEED_MOD, 3])
                        .integers(0, 2 ** 62)))
    weights = {fam["name"]: make_weights(
        spec.reference_kind(fam["kind"], root), fam, len(ids), x.shape[2],
        int(config["task"]["n_classes"]), gen) for fam, ids in cohorts}
    return Inputs(seed, config, traffic, x, y, ref_x, ref_y, cluster, names,
                  cohorts, weights)
