"""Inter-model similarity (paper Def. 4, Eq. 2), single device.

d_nm = (1/R) sum_j KL(s^n_j || s^m_j) — asymmetric; c_nm = 1/d_nm. The
(N,N) divergence matrix is the server's O(N^2 R C) hot spot, computed by
the ``pairwise_kl`` kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

EPS = 1e-8


def divergence_matrix(messengers_logp: torch.Tensor) -> torch.Tensor:
    """(N,R,C) log-messengers -> (N,N) fp32, D[n,m] = mean_j KL(n || m)."""
    return ops.pairwise_kl(messengers_logp)


def similarity_matrix(divergence: torch.Tensor) -> torch.Tensor:
    """c_nm = 1 / d_nm with a zero diagonal (a client is never its own
    neighbor); the EPS floor keeps identical twins finite."""
    c = 1.0 / torch.clamp(divergence, min=EPS)
    return c.fill_diagonal_(0.0)
