"""Client-availability schedules (numpy only, so they match the
reference's bit for bit). This slice carries ``always-on`` and
``staged-join``.

  available(rnd, n) -> (n,) bool   who trains & uploads THIS round
  joined(rnd, n)    -> (n,) bool   who is a member by now (eval averaging)
"""
from __future__ import annotations

import abc
from typing import Sequence

import numpy as np


class Schedule(abc.ABC):
    @abc.abstractmethod
    def available(self, rnd: int, n_clients: int) -> np.ndarray:
        """(n,) bool — clients that participate in round ``rnd``."""

    def joined(self, rnd: int, n_clients: int) -> np.ndarray:
        """(n,) bool — members as of round ``rnd`` (monotone schedules:
        the same as availability)."""
        return self.available(rnd, n_clients)

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class AlwaysOn(Schedule):
    """Every client participates every round (the synchronous baseline)."""

    def available(self, rnd: int, n_clients: int) -> np.ndarray:
        return np.ones(n_clients, bool)


class StagedJoin(Schedule):
    """Client n joins at ``join_round[n]`` and stays — the paper's §IV-F
    staged-facility scenario."""

    def __init__(self, join_round: Sequence[int]):
        self.join_round = np.asarray(join_round)

    def available(self, rnd: int, n_clients: int) -> np.ndarray:
        if self.join_round.shape[0] != n_clients:
            raise ValueError(f"join_round has {self.join_round.shape[0]} "
                             f"entries for {n_clients} clients")
        return self.join_round <= rnd

    def __repr__(self) -> str:
        return f"StagedJoin(stages={sorted(set(self.join_round.tolist()))})"

