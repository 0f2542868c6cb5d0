"""Eq. 5 distillation targets over the neighbor lists: the CUDA kernel
``csrc/neighbor_gather.cu`` (replacing the Pallas kernel
``repro/kernels/neighbor_mean.py::_kernel`` on the sparse graphs the
policies build) and its plain PyTorch version.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. ``launches`` counts kernel launches only.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.geometry import Cover, Geometry
from repro_torch.kernels.ref import neighbor_gather_ref as plain

# csrc/<SOURCE>.cu and its C entry point with its device pointers and ints
# (the stream comes last)
SOURCE, ENTRY = "neighbor_gather", "neighbor_gather"
ENTRIES = {ENTRY: (4, 8)}
DTYPES = (torch.float32, torch.bfloat16)
MAX_SLOTS = 4096   # a row's slots live in shared memory (8 bytes each)
THREADS = 128      # csrc/neighbor_gather.cu's block
launches = 0


def launch_args(n: int, k: int) -> Tuple[int, int, int, int]:
    """One block a target row, its K slots (index and weight, 8 bytes
    each) staged in dynamic shared memory."""
    return n, 1, THREADS, 8 * k


def launch_geometry(n: int, k: int) -> Geometry:
    gx, gy, threads, smem = launch_args(n, k)
    return Geometry(ENTRY, (gx, gy, 1), (threads, 1, 1), smem,
                    (Cover("rows (N)", 0, 1, n),))


def neighbor_gather(nbrs: torch.Tensor, w: torch.Tensor,
                    probs: torch.Tensor) -> torch.Tensor:
    """nbrs (N,K) int32 neighbor indices in [0, N), w (N,K) fp32 slot
    weights (0 on unrealized slots), probs (N,R,C) -> targets (N,R,C)
    fp32, T[n] = sum_j w[n,j] probs[nbrs[n,j]] in slot order."""
    if probs.dim() != 3 or nbrs.dim() != 2 or w.shape != nbrs.shape \
            or nbrs.shape[0] != probs.shape[0]:
        raise ValueError(f"expected nbrs (N,K), w (N,K) and probs (N,R,C), "
                         f"got {tuple(nbrs.shape)}, {tuple(w.shape)} and "
                         f"{tuple(probs.shape)}")
    devices = {nbrs.device, w.device, probs.device}
    if devices == {torch.device("cpu")}:
        return plain(nbrs, w, probs)
    if probs.device.type != "cuda" or len(devices) != 1:
        raise ValueError(f"nbrs, w and probs must be on one CUDA device, "
                         f"got {nbrs.device}, {w.device} and {probs.device}")
    if nbrs.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"nbrs must be int32 and w float32, got {nbrs.dtype}"
                        f" and {w.dtype}")
    if probs.dtype not in DTYPES:
        raise TypeError(f"probs must be float32 or bfloat16, got "
                        f"{probs.dtype}")
    if not (nbrs.is_contiguous() and w.is_contiguous()
            and probs.is_contiguous()):
        raise ValueError("nbrs, w and probs must be contiguous")
    n, r, c = probs.shape
    k = nbrs.shape[1]
    if k > MAX_SLOTS:
        raise ValueError(f"{k} slots a row exceed {MAX_SLOTS}; a graph this "
                         f"dense takes the dense entry neighbor_mean")
    if k == 0:              # no neighbor (I-SGD): zero targets, no launch
        return torch.zeros((n, r, c), dtype=torch.float32,
                           device=probs.device)
    out = torch.empty((n, r, c), dtype=torch.float32, device=probs.device)
    if out.numel() == 0:
        return out
    global launches
    fn = build.entry(SOURCE, ENTRY, *ENTRIES[ENTRY])
    code = fn(nbrs.data_ptr(), w.data_ptr(), probs.data_ptr(),
              out.data_ptr(), n, k, r * c,
              int(probs.dtype == torch.bfloat16),
              *launch_args(n, k),
              torch.cuda.current_stream(probs.device).cuda_stream)
    build.check(ENTRY, code)
    launches += 1
    return out
