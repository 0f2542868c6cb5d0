"""Eq. 5 distillation targets: the CUDA kernel ``csrc/neighbor_mean.cu``
(replacing the Pallas kernel ``repro/kernels/neighbor_mean.py::_kernel``)
and its plain PyTorch version.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import neighbor_mean_ref as plain

# csrc/<SOURCE>.cu, its C entry point, and the entry point's device
# pointers and ints (the stream comes last)
SOURCE, ENTRY, ARGS = "neighbor_mean", "neighbor_mean", (3, 3)
DTYPES = (torch.float32, torch.bfloat16)
launches = 0


def neighbor_mean(w: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """w (N,N) fp32 selection weights, probs (N,R,C) -> targets (N,R,C)
    fp32."""
    if probs.dim() != 3 or w.shape != (probs.shape[0], probs.shape[0]):
        raise ValueError(f"expected w (N,N) and probs (N,R,C), got "
                         f"{tuple(w.shape)} and {tuple(probs.shape)}")
    if w.device.type == "cpu" and probs.device.type == "cpu":
        return plain(w, probs)
    if probs.device.type != "cuda" or w.device != probs.device:
        raise ValueError(f"w and probs must be on one CUDA device, got "
                         f"{w.device} and {probs.device}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if probs.dtype not in DTYPES:
        raise TypeError(f"probs must be float32 or bfloat16, got "
                        f"{probs.dtype}")
    if not (w.is_contiguous() and probs.is_contiguous()):
        raise ValueError("w and probs must be contiguous")
    n, r, c = probs.shape
    out = torch.empty((n, r, c), dtype=torch.float32, device=probs.device)
    if out.numel() == 0:
        return out
    global launches
    fn = build.entry(SOURCE, ENTRY, *ARGS)
    code = fn(w.data_ptr(), probs.data_ptr(), out.data_ptr(), n, r * c,
              int(probs.dtype == torch.bfloat16),
              torch.cuda.current_stream(probs.device).cuda_stream)
    build.check(ENTRY, code)
    launches += 1
    return out
