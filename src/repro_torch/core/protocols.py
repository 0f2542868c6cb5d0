"""Collaboration protocol configs. This slice of the port registers one
policy, the paper's SQMD: quality top-Q filter, then similarity top-K
neighbors on the dynamic directed graph."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Protocol:
    name: str                    # any registered policy
    rho: float = 0.8             # Eq. 6 trade-off
    q: int = 16                  # quality pool size
    k: int = 8                   # neighbors

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


def sqmd(q: int = 16, k: int = 8, rho: float = 0.8) -> Protocol:
    """The paper's protocol; the sync engine communicates every round."""
    return Protocol("sqmd", rho=rho, q=q, k=k)
