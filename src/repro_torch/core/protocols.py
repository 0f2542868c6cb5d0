"""Collaboration protocols: SQMD (the paper) and its three baselines
(§IV-A).

  SQMD   — quality top-Q filter, then similarity top-K neighbors on the
           dynamic directed graph.
  FedMD  — everyone distills toward the global average messenger (the
           Q = K = N degenerate case of SQMD).
  D-Dist — static random K-neighbor groups, no server filtering.
  I-SGD  — isolated local SGD, no collaboration (rho = 0).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Protocol:
    name: str                    # any registered policy
    rho: float = 0.8             # Eq. 6 trade-off
    q: int = 16                  # quality pool size (sqmd)
    k: int = 8                   # neighbors (sqmd, ddist)
    interval: int = 1            # communication interval I (Alg. 1)

    def __post_init__(self):
        from repro_torch.core.policies import (is_registered,
                                               registered_policies)
        if not is_registered(self.name):
            raise ValueError(f"unknown protocol {self.name!r}; registered "
                             f"policies: {registered_policies()}")
        if not 0.0 <= self.rho <= 1.0:
            raise ValueError(f"rho must be in [0, 1], got {self.rho}")
        if self.q < 1:
            raise ValueError(f"q must be >= 1, got {self.q}")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {self.interval}")

    @property
    def uses_reference(self) -> bool:
        from repro_torch.core.policies import get_policy
        return get_policy(self.name).uses_reference


def sqmd(q: int = 16, k: int = 8, rho: float = 0.8,
         interval: int = 1) -> Protocol:
    """The paper's protocol."""
    return Protocol("sqmd", rho=rho, q=q, k=k, interval=interval)


def fedmd(rho: float = 0.8, interval: int = 1) -> Protocol:
    return Protocol("fedmd", rho=rho, interval=interval)


def ddist(k: int = 8, rho: float = 0.8, interval: int = 1) -> Protocol:
    return Protocol("ddist", rho=rho, k=k, interval=interval)


def isgd() -> Protocol:
    return Protocol("isgd", rho=0.0)
