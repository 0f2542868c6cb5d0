"""Eq. 1 quality scores: the CUDA kernel ``csrc/soft_ce.cu`` (replacing
the Pallas kernel ``repro/kernels/soft_ce.py::_kernel``) and its plain
PyTorch version.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import soft_ce_ref as plain

# csrc/<SOURCE>.cu, its C entry point, and the entry point's device
# pointers and ints (the stream comes last)
SOURCE, ENTRY = "soft_ce", "soft_ce"
ENTRIES = {ENTRY: (3, 4)}
DTYPES = (torch.float32, torch.bfloat16)
MAX_C = 1024   # one thread loops over a row's C classes (see soft_ce.cu)
launches = 0


def soft_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (N,R,C), labels (R,) int32 -> (N,) fp32 summed CE; a label
    < 0 marks a padded row that contributes 0."""
    if logits.dim() != 3 or labels.shape != logits.shape[1:2]:
        raise ValueError(f"expected logits (N,R,C) and labels (R,), got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if logits.device.type == "cpu" and labels.device.type == "cpu":
        return plain(logits, labels)
    if logits.device.type != "cuda" or labels.device != logits.device:
        raise ValueError(f"logits and labels must be on one CUDA device, got "
                         f"{logits.device} and {labels.device}")
    if logits.dtype not in DTYPES:
        raise TypeError(f"logits must be float32 or bfloat16, got "
                        f"{logits.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    if not (logits.is_contiguous() and labels.is_contiguous()):
        raise ValueError("logits and labels must be contiguous")
    n, r, c = logits.shape
    if c > MAX_C:
        raise ValueError(f"soft_ce kernel takes at most {MAX_C} classes, "
                         f"got {c}")
    out = torch.empty((n,), dtype=torch.float32, device=logits.device)
    if n == 0:
        return out
    global launches
    fn = build.entry(SOURCE, ENTRY, *ENTRIES[ENTRY])
    code = fn(logits.data_ptr(), labels.data_ptr(), out.data_ptr(), n, r, c,
              int(logits.dtype == torch.bfloat16),
              torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(ENTRY, code)
    launches += 1
    return out
