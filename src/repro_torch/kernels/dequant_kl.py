"""Eq. 2 divergence strips straight off the int8 wire form: the CUDA
kernel ``csrc/dequant_kl.cu`` (replacing the Pallas kernel
``repro/kernels/dequant_kl.py::_kernel``), the row statistics it reads,
and its plain PyTorch version.

The kernel reconstructs ``l = q·scale − lse`` in registers, so the fp32
(N, R, C) decode never exists in device memory; device memory holds the
uint8 codes and O(N·R) fp32 row statistics. The zero point is an
additive per-row shift that cancels in the softmax, so the kernel never
reads it.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import int8_pairwise_kl_pair_ref as plain

# csrc/<SOURCE>.cu, its C entry point, and the entry point's device
# pointers and ints (the stream comes last)
SOURCE, ENTRY = "dequant_kl", "int8_pairwise_kl_pair"
ENTRIES = {ENTRY: (7, 4)}
SCALE_DTYPES = (torch.float32, torch.bfloat16)
TILE = 64                 # rows and columns of one block's output tile
MAX_ROW_TILES = 65535     # the launch grid's y limit (row tiles)
# the row-statistics pass decodes at most this many fp32 values at a time
# (16 MB): bounded like the reference's 256-row chunks, but sized by
# elements so a million-row strip is a few launches, not thousands
STATS_ELEMS = 1 << 22
launches = 0


def _check_pair(qa, sa, qb, sb) -> None:
    if qa.dim() != 3 or sa.shape != qa.shape[:2]:
        raise ValueError(f"shapes disagree: qa {tuple(qa.shape)}, sa "
                         f"{tuple(sa.shape)}")
    if qb.dim() != 3 or sb.shape != qb.shape[:2]:
        raise ValueError(f"shapes disagree: qb {tuple(qb.shape)}, sb "
                         f"{tuple(sb.shape)}")
    if qa.shape[1:] != qb.shape[1:]:
        raise ValueError(f"operands disagree on (R, C): qa "
                         f"{tuple(qa.shape)}, qb {tuple(qb.shape)}")


def _check_cuda(name: str, t: torch.Tensor, dtypes, device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def int8_row_stats(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """lse[n,r] = logsumexp_c(q[n,r,c] · scale[n,r]), fp32 (N, R), in row
    chunks of at most STATS_ELEMS decoded values: never the full fp32
    decode."""
    n, r, c = q.shape
    step = max(1, STATS_ELEMS // max(r * c, 1))
    outs = [torch.logsumexp(q[i:i + step].float()
                            * scale[i:i + step].float()[..., None], dim=-1)
            for i in range(0, n, step)]
    if not outs:
        return torch.empty((0, r), dtype=torch.float32, device=q.device)
    return torch.cat(outs, dim=0)


def int8_pairwise_kl_pair(qa: torch.Tensor, sa: torch.Tensor,
                          zpa: torch.Tensor, qb: torch.Tensor,
                          sb: torch.Tensor,
                          zpb: torch.Tensor) -> torch.Tensor:
    """qa (U,R,C) / qb (M,R,C) uint8 codes with per-row scale and zero
    point (U,R) / (M,R) -> (U,M) fp32, D[a,b] = (1/R) sum_j KL(A_a_j ||
    B_b_j) of the decoded messengers. ``scale`` may be fp32 or the
    payload's bf16 (cast to fp32 before the launch); ``zpa``/``zpb`` are
    read only by the plain version."""
    _check_pair(qa, sa, qb, sb)
    if all(t.device.type == "cpu" for t in (qa, sa, qb, sb)):
        return plain(qa, sa, zpa, qb, sb, zpb)
    dev = qa.device
    _check_cuda("qa", qa, (torch.uint8,), dev)
    _check_cuda("qb", qb, (torch.uint8,), dev)
    _check_cuda("sa", sa, SCALE_DTYPES, dev)
    _check_cuda("sb", sb, SCALE_DTYPES, dev)
    sa, sb = sa.float(), sb.float()
    return launch(qa, sa, int8_row_stats(qa, sa), qb, sb,
                  int8_row_stats(qb, sb))


def launch(qa: torch.Tensor, sa: torch.Tensor, la: torch.Tensor,
           qb: torch.Tensor, sb: torch.Tensor,
           lb: torch.Tensor) -> torch.Tensor:
    """The kernel on prepared CUDA operands: uint8 codes, fp32 scale and
    lse (``int8_row_stats``), all contiguous on one device."""
    u, r, c = qa.shape
    m = qb.shape[0]
    dev = qa.device
    for name, t in (("sa", sa), ("la", la), ("sb", sb), ("lb", lb)):
        _check_cuda(name, t, (torch.float32,), dev)
    if (u + TILE - 1) // TILE > MAX_ROW_TILES:
        raise ValueError(f"{u} rows exceed the launch grid "
                         f"({MAX_ROW_TILES * TILE}); split the strip")
    out = torch.empty((u, m), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    global launches
    fn = build.entry(SOURCE, ENTRY, *ENTRIES[ENTRY])
    code = fn(qa.data_ptr(), sa.data_ptr(), la.data_ptr(), qb.data_ptr(),
              sb.data_ptr(), lb.data_ptr(), out.data_ptr(), u, m, r, c,
              torch.cuda.current_stream(dev).cuda_stream)
    build.check(ENTRY, code)
    launches += 1
    return out
