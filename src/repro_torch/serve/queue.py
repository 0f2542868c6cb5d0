"""Micro-batching admission queue for query traffic.

Requests arrive at virtual times; a ``BatchPolicy`` decides how long
they may wait to be batched:

  immediate   serve every arrival instant (simultaneous arrivals still
              batch together, up to max_batch) — the latency-optimal,
              throughput-worst baseline
  micro       classic max-batch / max-wait admission: release a batch
              the moment ``max_batch`` requests are pending, or when the
              oldest pending request has waited ``max_wait`` (a partial
              batch — bursty traffic must not strand the tail)

Policies are registry-pluggable (``@register_batch_policy``) and
reachable by name from the serve CLI, ``name:max_batch``
parameterizes (e.g. ``"micro:16"``).

The queue itself is deterministic and unbounded: over-capacity arrivals
QUEUE (several full batches release back-to-back at the same flush) —
requests are never dropped. ``push`` returns the virtual deadline the
runtime must schedule a flush for; ``pop_due`` releases every batch due
at the flush instant.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Type, Union

import numpy as np

_EPS = 1e-9

_BATCH_POLICIES: Dict[str, Type["BatchPolicy"]] = {}


def register_batch_policy(name: str):
    def deco(cls: Type["BatchPolicy"]) -> Type["BatchPolicy"]:
        if name in _BATCH_POLICIES:
            raise ValueError(f"batch policy {name!r} already registered")
        cls.name = name
        _BATCH_POLICIES[name] = cls
        return cls

    return deco


def registered_batch_policies() -> Tuple[str, ...]:
    return tuple(sorted(_BATCH_POLICIES))


def get_batch_policy(name: str) -> Type["BatchPolicy"]:
    try:
        return _BATCH_POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown batch policy {name!r}; registered: "
                       f"{registered_batch_policies()}") from None


def as_batch_policy(spec: Union[None, str, "BatchPolicy"]) -> "BatchPolicy":
    """Coerce None/name/instance into a BatchPolicy (None => micro).
    ``name:max_batch`` parameterizes, e.g. ``"micro:16"``."""
    if isinstance(spec, BatchPolicy):
        return spec
    if spec is None:
        return get_batch_policy("micro")()
    name, _, arg = spec.partition(":")
    return get_batch_policy(name).from_arg(arg)


class BatchPolicy(abc.ABC):
    """Admission parameters: how large batches grow and how long the
    oldest pending request may wait before a partial batch releases."""

    name: str = "?"

    def __init__(self, max_batch: int = 32, max_wait: float = 0.25):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)

    @classmethod
    def from_arg(cls, arg: str) -> "BatchPolicy":
        return cls(max_batch=int(arg)) if arg else cls()

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(max_batch={self.max_batch}, "
                f"max_wait={self.max_wait})")


@register_batch_policy("immediate")
class Immediate(BatchPolicy):
    """Zero queueing delay: flush at every arrival instant."""

    def __init__(self, max_batch: int = 64):
        super().__init__(max_batch=max_batch, max_wait=0.0)


@register_batch_policy("micro")
class MicroBatch(BatchPolicy):
    """max-batch / max-wait micro-batching (the serving default)."""


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """One personalized query: which client asks, with what features."""
    client_id: int
    x: np.ndarray
    t_arrival: float
    seq: int


class MicroBatchQueue:
    """Pending-request buffer releasing batches per the policy.

    Virtual-time discipline: ``push(reqs, t)`` admits arrivals and
    returns the flush deadline they imply (``t`` itself when a batch is
    already releasable, ``oldest + max_wait`` otherwise, None when
    nothing new is due); ``pop_due(t)`` releases every full batch plus
    the timed-out partial one. FIFO within and across batches, so a
    request can never overtake an older one."""

    def __init__(self, policy: Union[None, str, BatchPolicy] = None):
        self.policy = as_batch_policy(policy)
        self._pending: List[QueryRequest] = []
        self.n_pushed = 0
        self.n_released = 0
        self.max_depth = 0

    @property
    def depth(self) -> int:
        return len(self._pending)

    def push(self, reqs: List[QueryRequest], t: float) -> Optional[float]:
        """Admit ``reqs`` arriving at ``t``; returns the virtual time a
        flush must run, or None when no new deadline is needed."""
        if not reqs:
            return None
        self._pending.extend(reqs)
        self.n_pushed += len(reqs)
        self.max_depth = max(self.max_depth, len(self._pending))
        pol = self.policy
        if len(self._pending) >= pol.max_batch or pol.max_wait == 0.0:
            return float(t)
        return self._pending[0].t_arrival + pol.max_wait

    def next_deadline(self) -> Optional[float]:
        """When the current oldest pending request times out (None when
        the queue is empty)."""
        if not self._pending:
            return None
        return self._pending[0].t_arrival + self.policy.max_wait

    def pop_due(self, t: float) -> List[List[QueryRequest]]:
        """Release every batch due at ``t``: all full batches, then the
        partial batch whose oldest member has exhausted max_wait."""
        pol = self.policy
        batches: List[List[QueryRequest]] = []
        while len(self._pending) >= pol.max_batch:
            batches.append(self._pending[:pol.max_batch])
            self._pending = self._pending[pol.max_batch:]
        if self._pending and \
                self._pending[0].t_arrival + pol.max_wait <= t + _EPS:
            batches.append(self._pending)
            self._pending = []
        self.n_released += sum(len(b) for b in batches)
        return batches
