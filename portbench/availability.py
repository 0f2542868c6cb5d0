"""The one generator of traffic: which clients wake in a round, from a
mix's parameters (``portbench/traffic/<mix>.json``), the seed and the
round. A frozen copy of the port's ``AlwaysOn`` and ``RandomDropout``
draws:

* ``{"schedule": "always-on"}``: every client, every round;
* ``{"schedule": "dropout", "p": 0.5}``: each client misses a round with
  probability p, drawn from numpy's Philox keyed by (seed, round); at
  least one client always wakes.
"""
from __future__ import annotations

import numpy as np

SEED_MOD = 2 ** 63


def mask(traffic: dict, seed: int, rnd: int, n: int) -> np.ndarray:
    kind = traffic["schedule"]
    if kind == "always-on":
        return np.ones(n, bool)
    if kind == "dropout":
        p = float(traffic["p"])
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout p must be in [0, 1), got {p}")
        rng = np.random.default_rng([seed % SEED_MOD, 11, rnd])
        up = rng.random(n) >= p
        if not up.any():
            up[0] = True
        return up
    raise ValueError(f"unknown schedule {kind!r} in the traffic mix")
