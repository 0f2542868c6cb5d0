"""Query-traffic arrival processes — who asks their model, and when.

The training side already models *device* arrivals with the
``ArrivalProcess`` registry; query traffic reuses the exact same
abstraction (wakes = "these clients issue a query now"), so the
QueryRuntime rides the registries and the event loop unchanged. Two
serving-shaped processes register here:

  query-poisson   independent per-client Poisson streams at ``rate``
                  queries / client / virtual second — the memoryless
                  steady-state baseline
  query-diurnal   a sinusoidally rate-modulated (diurnal) Poisson
                  process with optional burst spikes every ``period``
                  — peak-hour traffic crests while training still runs

Both are pure functions of (seed, args), drawn with numpy: replaying
the same workload against a different batch policy is an apples-to-
apples comparison, and the wakes are the reference's exactly.

``split_query_stream`` supplies the feature vectors: client ``c``'s
k-th query replays its own held-out test sample ``k mod len`` — queries
ask about the data distribution the client actually owns, and the
serving-parity test can pin served logits bit-identical to direct
evaluation on the same inputs.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from repro_torch.core.schedules import (ArrivalProcess, Wake,
                                        register_arrivals)


def _merge_client_times(times_per_client: List[np.ndarray],
                        n_clients: int) -> List[Wake]:
    """Group per-client event times into sorted (t, mask) wakes."""
    by_t: Dict[float, np.ndarray] = {}
    for c, ts in enumerate(times_per_client):
        for t in ts:
            by_t.setdefault(float(t), np.zeros(n_clients, bool))[c] = True
    return [(t, by_t[t]) for t in sorted(by_t)]


@register_arrivals("query-poisson")
class PoissonQueries(ArrivalProcess):
    """Independent per-client Poisson query streams.

    ``rate`` is queries per client per virtual second; expected total
    load is ``rate * n_clients`` qps on the serving path."""

    def __init__(self, rate: float = 0.5, seed: int = 0):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.seed = seed

    def wakes(self, n_clients: int, until: float) -> List[Wake]:
        per_client = []
        for c in range(n_clients):
            rng = np.random.default_rng((self.seed, 13, c))
            ts, t = [], 0.0
            while True:
                t += rng.exponential(1.0 / self.rate)
                t6 = round(t, 6)
                if t6 > until:
                    break
                ts.append(t6)
            per_client.append(np.asarray(ts))
        return _merge_client_times(per_client, n_clients)

    def __repr__(self) -> str:
        return f"PoissonQueries(rate={self.rate})"


@register_arrivals("query-diurnal")
class DiurnalQueries(ArrivalProcess):
    """Diurnal (sinusoidal) rate modulation with optional burst crests.

    Instantaneous per-client rate::

        lam(t) = base_rate * (1 + amp * sin(2*pi * t / period))

    realized by Lewis-Shedler thinning of a ``base_rate * (1 + amp)``
    Poisson stream — deterministic per (seed, client). ``burst_frac`` > 0
    additionally wakes that fraction of clients together at every peak
    (t = period/4 mod period): the flash-crowd spike a max-wait policy
    must absorb without stranding the off-peak tail."""

    def __init__(self, base_rate: float = 0.5, amp: float = 0.8,
                 period: float = 8.0, burst_frac: float = 0.0,
                 seed: int = 0):
        if base_rate <= 0:
            raise ValueError(f"base_rate must be > 0, got {base_rate}")
        if not 0.0 <= amp <= 1.0:
            raise ValueError(f"amp must be in [0, 1], got {amp}")
        if period <= 0:
            raise ValueError(f"period must be > 0, got {period}")
        if not 0.0 <= burst_frac <= 1.0:
            raise ValueError(f"burst_frac must be in [0, 1], got "
                             f"{burst_frac}")
        self.base_rate = float(base_rate)
        self.amp = float(amp)
        self.period = float(period)
        self.burst_frac = float(burst_frac)
        self.seed = seed

    def _rate(self, t: float) -> float:
        return self.base_rate * (
            1.0 + self.amp * np.sin(2.0 * np.pi * t / self.period))

    def wakes(self, n_clients: int, until: float) -> List[Wake]:
        lam_max = self.base_rate * (1.0 + self.amp)
        per_client = []
        for c in range(n_clients):
            rng = np.random.default_rng((self.seed, 17, c))
            ts, t = [], 0.0
            while True:
                t += rng.exponential(1.0 / lam_max)
                t6 = round(t, 6)
                if t6 > until:
                    break
                if rng.random() <= self._rate(t6) / lam_max:   # thinning
                    ts.append(t6)
            per_client.append(np.asarray(ts))
        wakes = _merge_client_times(per_client, n_clients)
        if self.burst_frac > 0.0:
            by_t = {t: m for t, m in wakes}
            k, peak = 0, self.period / 4.0
            while k * self.period + peak <= until + 1e-9:
                t6 = round(k * self.period + peak, 6)
                rng = np.random.default_rng((self.seed, 19, k))
                burst = rng.random(n_clients) < self.burst_frac
                if t6 in by_t:
                    by_t[t6] = by_t[t6] | burst
                else:
                    by_t[t6] = burst
                k += 1
            wakes = [(t, by_t[t]) for t in sorted(by_t)]
        return wakes

    def __repr__(self) -> str:
        return (f"DiurnalQueries(base_rate={self.base_rate}, "
                f"amp={self.amp}, period={self.period}, "
                f"burst_frac={self.burst_frac})")


def split_query_stream(splits) -> Callable[[int, int], np.ndarray]:
    """Feature source replaying each client's own test samples in order
    (k-th query -> sample ``k mod len``): deterministic, and exactly the
    inputs a parity test compares against direct evaluation."""

    def features(client_id: int, k: int) -> np.ndarray:
        xs = np.asarray(splits[client_id].test_x)
        if len(xs) == 0:
            raise ValueError(f"client {client_id} has an empty test split "
                             f"— nothing to query with")
        return xs[k % len(xs)]

    return features
