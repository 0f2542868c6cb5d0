"""Eq. 2 divergence strips: the CUDA kernels of ``csrc/pairwise_kl.cu``
(replacing the Pallas kernel ``repro/kernels/pairwise_kl.py::_kernel``)
and their plain PyTorch version.

On the card a strip is two steps: a split pass that writes each operand
as TF32 hi and lo planes (and the A side's row term), then a ``wgmma``
GEMM over the planes (3xTF32). ``pairwise_kl`` splits the repository
once and runs every row strip over the same planes.

A CPU tensor takes the plain fp32 version; a CUDA tensor launches the
kernels or raises. ``launches`` counts GEMM launches, ``split_launches``
split launches; plain-version calls count nothing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import pairwise_kl_pair_ref as plain

# csrc/<SOURCE>.cu and its C entry points, each with its device pointers
# and ints (the stream comes last); ENTRY is the GEMM
SOURCE, ENTRY, SPLIT = ("pairwise_kl", "pairwise_kl_pair",
                        "pairwise_kl_split")
ENTRIES = {ENTRY: (6, 4), SPLIT: (4, 5)}
DTYPES = (torch.float32, torch.bfloat16)
BK = 32          # the GEMM's k-tile: the planes' rows pad to a multiple
launches = 0
split_launches = 0


class Split(NamedTuple):
    """One operand of the GEMM, as the split pass leaves it."""
    planes: torch.Tensor             # (2, rows, k_pad) fp32: hi, lo
    rowterm: Optional[torch.Tensor]  # (rows,) fp32 sum_k p l; A side only
    r: int                           # R, the divisor of the epilogue

    def rows(self, lo: int, hi: int) -> "Split":
        """Rows [lo, hi) as views of the same planes."""
        rt = None if self.rowterm is None else self.rowterm[lo:hi]
        return Split(self.planes[:, lo:hi], rt, self.r)


def _check(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def split(logp: torch.Tensor, a_side: bool) -> Split:
    """The split pass on the card: logp (rows,R,C) -> planes of p = exp(l)
    and the row term (A side) or of l (B side), K padded to BK."""
    global split_launches
    _check("logp", logp)
    rows, r, c = logp.shape
    k = r * c
    k_pad = -(-k // BK) * BK
    planes = torch.empty((2, rows, k_pad), dtype=torch.float32,
                         device=logp.device)
    rowterm = (torch.empty(rows, dtype=torch.float32, device=logp.device)
               if a_side else None)
    if rows:
        fn = build.entry(SOURCE, SPLIT, *ENTRIES[SPLIT])
        code = fn(logp.data_ptr(), planes[0].data_ptr(),
                  planes[1].data_ptr(),
                  rowterm.data_ptr() if a_side else None, rows, k, k_pad,
                  int(a_side), int(logp.dtype == torch.bfloat16),
                  _stream(logp))
        build.check(SPLIT, code)
        split_launches += 1
    return Split(planes, rowterm, r)


def gemm(a: Split, b: Split,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 3xTF32 GEMM over split operands -> (U, M) fp32 strip, written
    into ``out`` (a contiguous (U, M) fp32 view) when one is given."""
    global launches
    (_, u, k_pad), m = a.planes.shape, b.planes.shape[1]
    if a.rowterm is None or b.rowterm is not None \
            or b.planes.shape[2] != k_pad or a.r != b.r:
        raise ValueError("gemm takes an A-side and a B-side split of one "
                         "messenger shape")
    if out is None:
        out = torch.empty((u, m), dtype=torch.float32,
                          device=a.planes.device)
    elif out.shape != (u, m) or out.dtype != torch.float32 \
            or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous ({u}, {m}) fp32 tensor")
    if out.numel() == 0:
        return out
    fn = build.entry(SOURCE, ENTRY, *ENTRIES[ENTRY])
    code = fn(a.planes[0].data_ptr(), a.planes[1].data_ptr(),
              b.planes[0].data_ptr(), b.planes[1].data_ptr(),
              a.rowterm.data_ptr(), out.data_ptr(), u, m, k_pad, a.r,
              _stream(out))
    build.check(ENTRY, code)
    launches += 1
    return out


def _check_shapes(logp_a: torch.Tensor, logp_b: torch.Tensor) -> None:
    if logp_a.dim() != 3 or logp_b.dim() != 3 \
            or logp_a.shape[1:] != logp_b.shape[1:]:
        raise ValueError(f"messenger shapes disagree: {tuple(logp_a.shape)}"
                         f" vs {tuple(logp_b.shape)}")


def _check_card(logp_a: torch.Tensor, logp_b: torch.Tensor) -> None:
    _check("logp_a", logp_a)
    _check("logp_b", logp_b)
    if logp_a.dtype != logp_b.dtype or logp_a.device != logp_b.device:
        raise ValueError("logp_a and logp_b must share dtype and device")


def pairwise_kl_pair(logp_a: torch.Tensor,
                     logp_b: torch.Tensor) -> torch.Tensor:
    """logp_a (U,R,C), logp_b (M,R,C) log-messengers -> (U,M) fp32,
    D[a,b] = (1/R) sum_j KL(A_a_j || B_b_j): two split launches and one
    GEMM on the card."""
    _check_shapes(logp_a, logp_b)
    if logp_a.device.type == "cpu" and logp_b.device.type == "cpu":
        return plain(logp_a, logp_b)
    _check_card(logp_a, logp_b)
    return gemm(split(logp_a, True), split(logp_b, False))


def pairwise_kl(logp: torch.Tensor, chunk_rows: int) -> torch.Tensor:
    """The square (N,N) matrix as row strips of at most ``chunk_rows``
    rows; on the card the repository is split once (A and B side) and
    each strip's GEMM reads the same planes and writes its rows of the
    result in place."""
    _check_shapes(logp, logp)
    n = logp.shape[0]
    if logp.device.type == "cpu":
        return torch.cat([plain(logp[i:i + chunk_rows], logp)
                          for i in range(0, max(n, 1), chunk_rows)], dim=0)
    _check_card(logp, logp)
    a, b = split(logp, True), split(logp, False)
    out = torch.empty((n, n), dtype=torch.float32, device=logp.device)
    for i in range(0, n, chunk_rows):
        gemm(a.rows(i, i + chunk_rows), b, out[i:i + chunk_rows])
    return out
