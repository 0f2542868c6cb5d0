"""Eq. 2 divergence strips straight off the int8 wire form: the CUDA
kernels of ``csrc/dequant_kl.cu`` (replacing the Pallas kernel
``repro/kernels/dequant_kl.py::_kernel``), the row statistics the plain
version computes, and the plain PyTorch version.

On the card a strip takes one of two routes, by shape:

- thin, when its shorter side has at most THIN_ROWS rows whose decode
  fits in THIN_SMEM bytes of shared memory: one launch of the thin
  kernel (an IVF upload's 1 x m and m x 1 strips);
- wide otherwise: the dequant split writes each operand as the TF32 hi
  and lo planes of ``pairwise_kl.Split``, and B1's 3xTF32 GEMM
  (``pairwise_kl.gemm``) contracts them.

Both routes read the lse a caller passes (the IVF index stores it) and
compute it in the kernel otherwise, so the fp32 (N, R, C) decode never
exists in device memory beyond one strip's planes. The zero point is an
additive per-row shift that cancels in the softmax; no route reads it.

A CPU tensor takes the plain version; a CUDA tensor launches the kernels
or raises. ``launches`` counts the GEMMs run on int8 splits (B1's own
counter does not see them), ``split_launches`` and ``thin_launches`` the
two kernels of this source; plain-version calls count nothing.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import pairwise_kl as pk
from repro_torch.kernels import ref
from repro_torch.kernels.geometry import Cover, Geometry, blocks, num_sms

# csrc/<SOURCE>.cu, its C entry points, and each entry point's device
# pointers and ints (the stream comes last)
SOURCE = "dequant_kl"
SPLIT, THIN = "int8_pairwise_kl_split", "int8_pairwise_kl_thin"
THIN_BLOCKS = "int8_pairwise_kl_thin_blocks"
ENTRY = SPLIT
ENTRIES = {SPLIT: (6, 10), THIN: (7, 11), THIN_BLOCKS: (1, 3)}
WARPS = 8        # csrc/dequant_kl.cu's warps a block (whole rows each)
SCALE_DTYPES = (torch.float32, torch.bfloat16)
# a strip whose shorter side has at most THIN_ROWS rows takes the thin
# kernel, if that side's decode fits in THIN_SMEM bytes of shared memory:
# on an H100 the thin kernel's device time beat the wide route's at 1, 8
# and 16 thin rows (K = 80 and K = 2400) and lost at 32 and 64 (PERF.md);
# the kernel takes no more (csrc/dequant_kl.cu's THIN_ROWS)
THIN_ROWS = 16
THIN_SMEM = 200 * 1024    # of the 227 KB a block may take
# the row-statistics pass decodes at most this many fp32 values at a time
# (16 MB): bounded like the reference's 256-row chunks, but sized by
# elements so a million-row strip is a few launches, not thousands
STATS_ELEMS = 1 << 22
launches = 0
split_launches = 0
thin_launches = 0


def split_args(rows: int) -> Tuple[int, int, int, int]:
    """The dequant split's launch over ``rows`` rows: one warp a row,
    WARPS rows a block."""
    return blocks(rows, WARPS), 1, 32 * WARPS, 0


def split_geometry(rows: int) -> Geometry:
    gx, gy, threads, smem = split_args(rows)
    return Geometry(SPLIT, (gx, gy, 1), (threads, 1, 1), smem,
                    (Cover("rows", 0, WARPS, rows),))


def thin_tb(t: int) -> int:
    """The thin kernel instance for ``t`` thin rows: the smallest of 1,
    2, 4, 8, 16 at least ``t``."""
    return 1 << (t - 1).bit_length() if t > 1 else 1


def thin_smem(t: int, r: int, c: int, have_lt: bool) -> int:
    """Dynamic shared memory of the thin kernel: the thin side's decode
    (T, K) fp32, its row terms, and its lse when the kernel computes it."""
    return 4 * (t * r * c + t + (0 if have_lt else t * r))


def _thin_rows_per_block(t: int) -> int:
    """Many-side rows a thin block covers a pass: each warp carries 4 (2
    above 8 thin rows)."""
    return WARPS * (4 if thin_tb(t) <= 8 else 2)


def thin_args(t: int, m: int, r: int, c: int, have_lt: bool, sms: int,
              blocks_per_sm: int) -> Tuple[int, int, int, int]:
    """The thin kernel's persistent grid: enough blocks to cover the many
    side's ``m`` rows once, but never more than the card holds at once
    (``blocks_per_sm`` resident blocks on each of ``sms`` SMs); the blocks
    then stride over the rest."""
    grid = max(1, min(blocks(m, _thin_rows_per_block(t)),
                      blocks_per_sm * sms))
    return grid, 1, 32 * WARPS, thin_smem(t, r, c, have_lt)


def thin_geometry(t: int, m: int, r: int, c: int, have_lt: bool,
                  sms: int, blocks_per_sm: int) -> Geometry:
    gx, gy, threads, smem = thin_args(t, m, r, c, have_lt, sms,
                                      blocks_per_sm)
    per_block = _thin_rows_per_block(t)
    return Geometry(THIN, (gx, gy, 1), (threads, 1, 1), smem,
                    (Cover("many-side rows (M)", 0, per_block, m,
                           passes=blocks(m, gx * per_block)),))


# resident thin blocks an SM, by (device, instance, vector width, smem)
_THIN_BLOCKS: Dict[Tuple[int, int, int, int], int] = {}


def thin_blocks_per_sm(device: torch.device, t: int, vec: int,
                       smem: int) -> int:
    """How many thin blocks of ``smem`` bytes an SM of ``device`` holds,
    asked of the CUDA occupancy calculator once a (device, instance,
    vector width, size)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (idx, thin_tb(t), vec, smem)
    if key not in _THIN_BLOCKS:
        got = ctypes.c_int(0)
        fn = build.entry(SOURCE, THIN_BLOCKS, *ENTRIES[THIN_BLOCKS])
        with torch.cuda.device(idx):
            build.check(THIN_BLOCKS, fn(ctypes.addressof(got), t, vec, smem,
                                        None))
        if got.value < 1:
            raise RuntimeError(f"the thin kernel does not fit an SM at "
                               f"{smem} bytes of shared memory")
        _THIN_BLOCKS[key] = got.value
    return _THIN_BLOCKS[key]


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


def _check_lse(name: str, lse: Optional[torch.Tensor], q) -> None:
    if lse is not None and lse.shape != q.shape[:2]:
        raise ValueError(f"{name} must be {tuple(q.shape[:2])}, got "
                         f"{tuple(lse.shape)}")


def _check_cuda(name: str, t: torch.Tensor, dtypes, device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_card(qa, sa, qb, sb, lse_a, lse_b, scale_dtypes) -> None:
    """Every operand a contiguous CUDA tensor on qa's device, of its type:
    uint8 codes, scales of ``scale_dtypes``, fp32 lse where given."""
    dev = qa.device
    _check_cuda("qa", qa, (torch.uint8,), dev)
    _check_cuda("qb", qb, (torch.uint8,), dev)
    _check_cuda("sa", sa, scale_dtypes, dev)
    _check_cuda("sb", sb, scale_dtypes, dev)
    for name, t in (("lse_a", lse_a), ("lse_b", lse_b)):
        if t is not None:
            _check_cuda(name, t, (torch.float32,), dev)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def int8_row_stats(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """lse[n,r] = logsumexp_c(q[n,r,c] · scale[n,r]), fp32 (N, R), in row
    chunks of at most STATS_ELEMS decoded values: never the full fp32
    decode. The plain version's helper; the kernels compute their own."""
    n, r, c = q.shape
    step = max(1, STATS_ELEMS // max(r * c, 1))
    outs = [torch.logsumexp(q[i:i + step].float()
                            * scale[i:i + step].float()[..., None], dim=-1)
            for i in range(0, n, step)]
    if not outs:
        return torch.empty((0, r), dtype=torch.float32, device=q.device)
    return torch.cat(outs, dim=0)


def plain(qa: torch.Tensor, sa: torch.Tensor, qb: torch.Tensor,
          sb: torch.Tensor, lse_a: Optional[torch.Tensor] = None,
          lse_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: decode l = q·scale − lse (lse from
    ``int8_row_stats`` where not given), then the fp32 strip."""
    la = int8_row_stats(qa, sa) if lse_a is None else lse_a
    lb = int8_row_stats(qb, sb) if lse_b is None else lse_b
    return ref.pairwise_kl_pair_ref(ref.int8_decode_ref(qa, sa, la),
                                    ref.int8_decode_ref(qb, sb, lb))


def thin_fits(t: int, r: int, c: int) -> bool:
    """Whether a strip whose shorter side has ``t`` rows takes the thin
    route: at most THIN_ROWS rows, whose decode (and its lse, if the
    kernel computes it) fits in THIN_SMEM bytes."""
    return 1 <= t <= THIN_ROWS and 4 * t * (r * c + 1 + r) <= THIN_SMEM


def split(q: torch.Tensor, scale: torch.Tensor, a_side: bool,
          lse: Optional[torch.Tensor] = None
          ) -> Tuple[pk.Split, torch.Tensor]:
    """The dequant split on the card: q (rows,R,C) uint8 and fp32 scale
    (rows,R) -> (the planes ``pairwise_kl.split`` writes for the decoded
    l = q·scale − lse, the (rows,R) lse it read or computed)."""
    global split_launches
    dev = q.device
    _check_cuda("q", q, (torch.uint8,), dev)
    _check_cuda("scale", scale, (torch.float32,), dev)
    _check_lse("lse", lse, q)
    rows, r, c = q.shape
    k_pad = -(-r * c // pk.BK) * pk.BK
    have = lse is not None
    if have:
        _check_cuda("lse", lse, (torch.float32,), dev)
    else:
        lse = torch.empty((rows, r), dtype=torch.float32, device=dev)
    planes = torch.empty((2, rows, k_pad), dtype=torch.float32, device=dev)
    rowterm = (torch.empty(rows, dtype=torch.float32, device=dev)
               if a_side else None)
    if rows:
        fn = build.entry(SOURCE, SPLIT, *ENTRIES[SPLIT])
        code = fn(q.data_ptr(), scale.data_ptr(), lse.data_ptr(),
                  planes[0].data_ptr(), planes[1].data_ptr(),
                  rowterm.data_ptr() if a_side else None, rows, r, c, k_pad,
                  int(a_side), int(have), *split_args(rows),
                  _stream(q))
        build.check(SPLIT, code)
        split_launches += 1
    return pk.Split(planes, rowterm, r), lse


def _count_gemm() -> None:
    global launches
    launches += 1


def gemm(a: pk.Split, b: pk.Split,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B1's 3xTF32 GEMM over int8 splits, counted under ``launches``."""
    return pk.gemm(a, b, out, count=_count_gemm)


def wide(qa: torch.Tensor, sa: torch.Tensor, qb: torch.Tensor,
         sb: torch.Tensor, lse_a: Optional[torch.Tensor] = None,
         lse_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The wide route on the card: a dequant split of each side, then the
    3xTF32 GEMM -> (U, M) fp32. Scales fp32."""
    a, _ = split(qa, sa, True, lse_a)
    b, _ = split(qb, sb, False, lse_b)
    return gemm(a, b)


def thin(qa: torch.Tensor, sa: torch.Tensor, qb: torch.Tensor,
         sb: torch.Tensor, lse_a: Optional[torch.Tensor] = None,
         lse_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The thin kernel on the card: the shorter side (at most THIN_ROWS
    rows; A when U <= M) decoded into shared memory, against every row of
    the other -> (U, M) fp32. Scales fp32."""
    _check_pair(qa, sa, qb, sb)
    _check_lse("lse_a", lse_a, qa)
    _check_lse("lse_b", lse_b, qb)
    _check_card(qa, sa, qb, sb, lse_a, lse_b, (torch.float32,))
    return _thin(qa, sa, qb, sb, lse_a, lse_b)


def _thin(qa, sa, qb, sb, lse_a, lse_b) -> torch.Tensor:
    """``thin`` on checked operands."""
    global thin_launches
    u, r, c = qa.shape
    m = qb.shape[0]
    a_thin = u <= m
    (qt, st, lt), (qm, sm, lm) = (
        ((qa, sa, lse_a), (qb, sb, lse_b)) if a_thin
        else ((qb, sb, lse_b), (qa, sa, lse_a)))
    n_thin, n_many = qt.shape[0], qm.shape[0]
    if n_thin > THIN_ROWS:
        raise ValueError(f"the thin side has {n_thin} rows, more than "
                         f"{THIN_ROWS}")
    out = torch.empty((u, m), dtype=torch.float32, device=qa.device)
    if out.numel() == 0:
        return out
    have_lm = lm is not None
    if not have_lm:          # the kernel writes the many side's lse here
        lm = torch.empty((n_many, r), dtype=torch.float32, device=qa.device)
    have_lt = lt is not None
    # the vector width the entry point picks (csrc/dequant_kl.cu): 4 when
    # K % 4 == 0 and the many side's codes are 4-byte aligned
    vec = 4 if (r * c) % 4 == 0 and qm.data_ptr() % 4 == 0 else 1
    smem = thin_smem(n_thin, r, c, have_lt)
    launch = thin_args(n_thin, n_many, r, c, have_lt, num_sms(qa.device),
                       thin_blocks_per_sm(qa.device, n_thin, vec, smem))
    fn = build.entry(SOURCE, THIN, *ENTRIES[THIN])
    code = fn(qt.data_ptr(), st.data_ptr(),
              None if lt is None else lt.data_ptr(), qm.data_ptr(),
              sm.data_ptr(), lm.data_ptr(), out.data_ptr(), n_thin, n_many,
              r, c, int(a_thin), int(have_lt), int(have_lm), *launch,
              _stream(out))
    build.check(THIN, code)
    thin_launches += 1
    return out


def int8_pairwise_kl_pair(qa: torch.Tensor, sa: torch.Tensor,
                          zpa: torch.Tensor, qb: torch.Tensor,
                          sb: torch.Tensor, zpb: torch.Tensor,
                          lse_a: Optional[torch.Tensor] = None,
                          lse_b: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """qa (U,R,C) / qb (M,R,C) uint8 codes with per-row scale and zero
    point (U,R) / (M,R) -> (U,M) fp32, D[a,b] = (1/R) sum_j KL(A_a_j ||
    B_b_j) of the decoded messengers. ``scale`` may be fp32 or the
    payload's bf16 (cast to fp32 before the launch). ``lse_a``/``lse_b``
    (fp32 (U,R) / (M,R)) are the row statistics where the caller has
    them, computed otherwise; ``zpa``/``zpb`` are never read."""
    _check_pair(qa, sa, qb, sb)
    _check_lse("lse_a", lse_a, qa)
    _check_lse("lse_b", lse_b, qb)
    given = [t for t in (lse_a, lse_b) if t is not None]
    if all(t.device.type == "cpu" for t in (qa, sa, qb, sb, *given)):
        return plain(qa, sa, qb, sb, lse_a, lse_b)
    _check_card(qa, sa, qb, sb, lse_a, lse_b, SCALE_DTYPES)
    sa, sb = sa.float(), sb.float()
    u, r, c = qa.shape
    m = qb.shape[0]
    if u == 0 or m == 0:
        return torch.empty((u, m), dtype=torch.float32, device=qa.device)
    if thin_fits(min(u, m), r, c):
        return _thin(qa, sa, qb, sb, lse_a, lse_b)
    return wide(qa, sa, qb, sb, lse_a, lse_b)


def int8_pairwise_kl(q: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
                     chunk_rows: int) -> torch.Tensor:
    """The square (N,N) matrix of one int8 repository as row strips of at
    most ``chunk_rows`` rows. On the card the repository is split once
    for each side (the A side's split computes the lse, the B side's
    reads it) and each strip's GEMM writes its rows of the result in
    place."""
    _check_pair(q, scale, q, scale)
    n = q.shape[0]
    if q.device.type == "cpu" and scale.device.type == "cpu":
        lse = int8_row_stats(q, scale)
        return torch.cat([plain(q[i:i + chunk_rows], scale[i:i + chunk_rows],
                                q, scale, lse[i:i + chunk_rows], lse)
                          for i in range(0, max(n, 1), chunk_rows)], dim=0)
    _check_cuda("scale", scale, SCALE_DTYPES, q.device)
    scale = scale.float()
    a, lse = split(q, scale, True)
    b, _ = split(q, scale, False, lse)
    out = torch.empty((n, n), dtype=torch.float32, device=q.device)
    for i in range(0, n, chunk_rows):
        gemm(a.rows(i, i + chunk_rows), b, out[i:i + chunk_rows])
    return out
