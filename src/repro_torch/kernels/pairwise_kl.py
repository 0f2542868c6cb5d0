"""Eq. 2 divergence strips: the CUDA kernel ``csrc/pairwise_kl.cu``
(replacing the Pallas kernel ``repro/kernels/pairwise_kl.py::_kernel``)
and its plain PyTorch version.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import pairwise_kl_pair_ref as plain

# csrc/<SOURCE>.cu, its C entry point, and the entry point's device
# pointers and ints (the stream comes last)
SOURCE, ENTRY, ARGS = "pairwise_kl", "pairwise_kl_pair", (3, 5)
DTYPES = (torch.float32, torch.bfloat16)
launches = 0


def _check(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pairwise_kl_pair(logp_a: torch.Tensor,
                     logp_b: torch.Tensor) -> torch.Tensor:
    """logp_a (U,R,C), logp_b (M,R,C) log-messengers -> (U,M) fp32,
    D[a,b] = (1/R) sum_j KL(A_a_j || B_b_j). The square matrix is the
    ``logp_a is logp_b`` case."""
    if logp_a.dim() != 3 or logp_b.dim() != 3 \
            or logp_a.shape[1:] != logp_b.shape[1:]:
        raise ValueError(f"messenger shapes disagree: {tuple(logp_a.shape)}"
                         f" vs {tuple(logp_b.shape)}")
    if logp_a.device.type == "cpu" and logp_b.device.type == "cpu":
        return plain(logp_a, logp_b)
    _check("logp_a", logp_a)
    _check("logp_b", logp_b)
    if logp_a.dtype != logp_b.dtype or logp_a.device != logp_b.device:
        raise ValueError("logp_a and logp_b must share dtype and device")
    u, r, c = logp_a.shape
    m = logp_b.shape[0]
    out = torch.empty((u, m), dtype=torch.float32, device=logp_a.device)
    if out.numel() == 0:
        return out
    global launches
    fn = build.entry(SOURCE, ENTRY, *ARGS)
    code = fn(logp_a.data_ptr(), logp_b.data_ptr(), out.data_ptr(), u, m,
              r * c, r, int(logp_a.dtype == torch.bfloat16),
              torch.cuda.current_stream(logp_a.device).cuda_stream)
    build.check(ENTRY, code)
    launches += 1
    return out
