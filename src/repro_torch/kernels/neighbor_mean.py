"""Eq. 5 distillation targets on a dense W: the CUDA route of
``csrc/neighbor_mean.cu`` and B1's ``csrc/pairwise_kl.cu`` (replacing the
Pallas kernel ``repro/kernels/neighbor_mean.py::_kernel``) and its plain
PyTorch version.

On the card T = W S is three launches: W's TF32 hi and lo planes from
B1's split pass (its B-side mode: no exp, no row term), S^T's from the
transposing split of this source (wgmma reads TF32 operands K-major
only), then B1's 3xTF32 GEMM in its plain-store mode.

A CPU tensor takes the plain version; a CUDA tensor launches the kernels
or raises. ``launches`` counts the route's GEMMs (B1's own counter does
not see them), ``split_launches`` its splits, two a call (W's on B1's
split kernel, S's on the transposing one); plain-version calls count
nothing.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import pairwise_kl as pk
from repro_torch.kernels.geometry import Cover, Geometry, blocks
from repro_torch.kernels.ref import neighbor_mean_ref as plain

# csrc/<SOURCE>.cu, its C entry point, and the entry point's device
# pointers and ints (the stream comes last); the GEMM is B1's
SOURCE, ENTRY = "neighbor_mean", "neighbor_mean_split"
ENTRIES = {ENTRY: (3, 8)}
DTYPES = (torch.float32, torch.bfloat16)
# csrc/neighbor_mean.cu's transposing tile: TN rows of S (the planes' k)
# by TJ of its R*C columns, THREADS threads
TN, TJ, THREADS = 32, 64, 256
launches = 0
split_launches = 0


def split_args(rc: int, k_pad: int) -> Tuple[int, int, int, int]:
    """The transposing split of S (N, RC) into (RC, Kp) planes: x over
    RC in TJ columns, y over the planes' Kp = N padded in TN rows (every
    k tile, the zero pad included, is written)."""
    return blocks(rc, TJ), k_pad // TN, THREADS, 0


def split_geometry(rc: int, k_pad: int) -> Geometry:
    gx, gy, threads, smem = split_args(rc, k_pad)
    return Geometry(ENTRY, (gx, gy, 1), (threads, 1, 1), smem,
                    (Cover("S columns (RC)", 0, TJ, rc),
                     Cover("S rows (N, padded to Kp)", 1, TN, k_pad)))


def _count_split() -> None:
    global split_launches
    split_launches += 1


def _count_gemm() -> None:
    global launches
    launches += 1


def split_t(probs: torch.Tensor) -> pk.Split:
    """The transposing split on the card: probs (N,R,C) fp32 or bf16 ->
    the B operand of the GEMM, planes (2, R*C, Kp) of S^T with K = N
    padded to B1's k-tile."""
    n, r, c = probs.shape
    if probs.device.type != "cuda":
        raise ValueError(f"probs must be a CUDA tensor, got {probs.device}")
    if probs.dtype not in DTYPES:
        raise TypeError(f"probs must be float32 or bfloat16, got "
                        f"{probs.dtype}")
    if not probs.is_contiguous():
        raise ValueError("probs must be contiguous")
    k_pad = -(-n // pk.BK) * pk.BK
    planes = torch.empty((2, r * c, k_pad), dtype=torch.float32,
                         device=probs.device)
    if planes.numel():
        fn = build.entry(SOURCE, ENTRY, *ENTRIES[ENTRY])
        code = fn(probs.data_ptr(), planes[0].data_ptr(),
                  planes[1].data_ptr(), n, r * c, k_pad,
                  int(probs.dtype == torch.bfloat16),
                  *split_args(r * c, k_pad),
                  torch.cuda.current_stream(probs.device).cuda_stream)
        build.check(ENTRY, code)
        _count_split()
    return pk.Split(planes, None, 1)


def split_w(w: torch.Tensor) -> pk.Split:
    """W (N,N) fp32 on the card -> the A operand of the GEMM, its planes
    (2, N, Kp) from B1's split pass in its B-side mode."""
    n = w.shape[0]
    return pk.split(w.view(n, n, 1), False, count=_count_split)


def neighbor_mean(w: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """w (N,N) fp32 selection weights, probs (N,R,C) -> targets (N,R,C)
    fp32, T = W S."""
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
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    n, r, c = probs.shape
    out = torch.empty((n, r * c), dtype=torch.float32, device=probs.device)
    if out.numel():
        pk.gemm(split_w(w), split_t(probs), out, count=_count_gemm)
    return out.view(n, r, c)
