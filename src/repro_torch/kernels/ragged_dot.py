"""The dropless MoE's grouped product: the CUDA kernels
``csrc/ragged_dot.cu`` (the counterpart of ``jax.lax.ragged_dot``, which
the reference's ``moe_dropless_forward`` calls three times a layer; no
Pallas kernel) and their plain PyTorch versions, as two custom ops:

  * ``repro_torch::ragged_dot(lhs, rhs, group_sizes, transpose_rhs)``:
    lhs (M,K) with its rows sorted by group, rhs (G,K,N) (``transpose_rhs``:
    (G,N,K), read transposed in place), group_sizes (G,) int32 -> (M,N) in
    lhs's dtype; rows at or past sum(group_sizes) come out 0;
  * ``repro_torch::ragged_dot_wgrad(lhs, grad, group_sizes)`` -> (G,K,N),
    each group's lhs rows transposed times its grad rows (0 for an empty
    group).

The ops carry their own autograd (the input gradient is the forward on
rhs transposed, the weight gradient the second op), their fake shapes
(so a step on fake tensors traces them) and ``FlopCounterMode``'s
formula, 2 M K N a product, the reference's dense-equivalent count for
``ragged-dot`` (``launch/graph_cost.py`` reads the same registry).

A CPU tensor takes the plain version (one product a nonempty group, the
group sizes read on the host); a CUDA tensor launches a kernel or
raises. The kernels read the group sizes on the device only: nothing
here synchronises with the host.

Three routes a product, chosen by shape (``takes_tma``,
``takes_tf32``), never by a failure:

  * the Hopper route (bf16 whose K and N are multiples of 8 and whose
    operands are 16-byte aligned: every published MoE width;
    ``ragged_dot_tma`` / ``ragged_dot_wgrad_tma``): TMA loads into an
    mbarrier ring fed by one producer warp, two consumer warpgroups on
    ``wgmma`` m64n256k16 over 128 x 256 tiles, persistent blocks (one an
    SM) that walk a linear tile index (``tma_walk``,
    ``tma_wgrad_walk``). Bound: the bytes (every expert's weights read,
    or their gradient written, once; ~0.28 ms at mixtral-8x7b's widths,
    ~0.76 ms at deepseek-v2-236b's on 3.35 TB/s) or, at mixtral's 2048
    train rows, as much the 240 GFLOP (~0.24 ms at 989 TFLOP/s);
  * the fp32 Hopper route (fp32 whose K and N are multiples of 4 and
    whose operands are 16-byte aligned; ``csrc/ragged_dot_tf32.cu``):
    3xTF32 on ``wgmma``. The forward splits lhs into TF32 hi/lo planes
    (B1's split pass, ``pairwise_kl_split``), then ``ragged_dot_tf32``
    computes each 128-column tile transposed, the weights as wgmma's A
    from registers (split there) and up to 144 of a group's rows as its
    N (``tf32_walk``);
    the weight gradient splits lhs and grad transposed, each group padded
    to whole 32-row stages (``ragged_dot_wgrad_tf32_split``), then
    ``ragged_dot_wgrad_tf32`` runs B1's 3xTF32 product over each group's
    stages (``tf32_wgrad_walk``). Bound: the bytes at prefill (1.88 GB
    of mixtral-8x7b's fp32 weights, ~0.57 ms), the 3 x 2 M K N TF32
    flops at its 2048 train rows (~1.46 ms at 495 TFLOP/s);
  * the first route (bf16 and fp32 at other shapes, on WMMA and IEEE
    FFMA, cp.async rings; ``ragged_dot`` / ``ragged_dot_wgrad``).

``launches`` and ``wgrad_launches`` count the calls that launched a
route's product (one a call, whichever route); ``tma_launches`` and
``tma_wgrad_launches`` the Hopper route's, ``tf32_launches``,
``tf32_wgrad_launches``, ``tf32_split_launches`` and
``tf32_wgrad_split_launches`` the fp32 Hopper route's kernels.
"""
from __future__ import annotations

import bisect
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels import pairwise_kl as pk
from repro_torch.kernels.geometry import (H100_SMS, Cover, Geometry,
                                          TensorMap, blocks, num_sms)
from repro_torch.kernels.ref import ragged_dot_ref as plain
from repro_torch.kernels.ref import ragged_dot_wgrad_ref as plain_wgrad

# csrc/<SOURCE>.cu and its C entry points with their device pointers and
# ints (the stream comes last)
SOURCE = "ragged_dot"
ENTRY, WGRAD_ENTRY = "ragged_dot", "ragged_dot_wgrad"
TMA_ENTRY, TMA_WGRAD_ENTRY = "ragged_dot_tma", "ragged_dot_wgrad_tma"
ENTRIES = {ENTRY: (4, 10), WGRAD_ENTRY: (4, 10), TMA_ENTRY: (4, 8),
           TMA_WGRAD_ENTRY: (4, 7)}
# the fp32 Hopper route's source and entry points (its forward's split is
# B1's, csrc/pairwise_kl.cu's pairwise_kl_split)
TF32_SOURCE = "ragged_dot_tf32"
TF32_ENTRY = "ragged_dot_tf32"
TF32_WGRAD_SPLIT_ENTRY = "ragged_dot_wgrad_tf32_split"
TF32_WGRAD_ENTRY = "ragged_dot_wgrad_tf32"
TF32_ENTRIES = {TF32_ENTRY: (4, 8), TF32_WGRAD_SPLIT_ENTRY: (5, 10),
                TF32_WGRAD_ENTRY: (4, 8)}
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUPS = 1024  # the group tables live in a block's shared memory
BM, BN, BK = 64, 128, 32   # csrc/ragged_dot.cu's output tile and stage
THREADS = 256              # csrc/ragged_dot.cu's block
STAGES = {2: 4, 4: 3}      # its forward's ring stages, by element size
WGRAD_STAGES = 2           # its weight gradient's
# the Hopper route: a 128 x 256 tile (two consumer warpgroups of 64 rows),
# 64-deep stages, the ring's stages, a producer warpgroup and two
# consumers, the ring + 1024 bytes of alignment, one persistent block an
# SM
TMA_BM, TMA_BN, TMA_BK = 128, 256, 64
TMA_STAGES = 4
TMA_THREADS = 384
TMA_SMEM = TMA_STAGES * (TMA_BM * TMA_BK + TMA_BK * TMA_BN) * 2 + 1024
TMA_BLOCKS_PER_SM = 1
# the fp32 Hopper route (csrc/ragged_dot_tf32.cu): 32-deep stages (one
# 128-byte swizzle row of fp32); the forward's 128-column tiles of up to
# 144 rows of a group, rounded up to 16, a ring of 4 stages (a 128 x 32
# weight tile, lhs's hi and lo 144 x 32 tiles) and 1024 bytes of
# alignment; the weight gradient's 128 x 128 tiles over a ring of 3 stages
# of four 128 x 32 plane tiles; the transposing split's tile (32 padded
# columns by 64 columns)
TF32_BK = 32
TF32_BN, TF32_BR, TF32_ROW_STEP = 128, 144, 16
TF32_STAGES = 4
TF32_SMEM = TF32_STAGES * (TF32_BN + 2 * TF32_BR) * TF32_BK * 4 + 1024
TF32_WG_BM, TF32_WG_BN = 128, 128
TF32_WG_STAGES = 3
TF32_WG_SMEM = TF32_WG_STAGES * 4 * 128 * TF32_BK * 4 + 1024
TF32_TN, TF32_TJ, TF32_SPLIT_T_THREADS = 32, 64, 256
launches = 0
wgrad_launches = 0
tma_launches = 0
tma_wgrad_launches = 0
tf32_launches = 0
tf32_wgrad_launches = 0
tf32_split_launches = 0
tf32_wgrad_split_launches = 0


def ring_bytes(elem: int, a: Tuple[int, int], b: Tuple[int, int],
               stages: int) -> int:
    """A ring of stages in dynamic shared memory: each stage an (R, C)
    tile of A and of B, rows padded by 16 bytes, rounded to 128 bytes."""
    v = 16 // elem
    stage = (a[0] * (a[1] + v) + b[0] * (b[1] + v)) * elem
    return stages * (-(-stage // 128) * 128)


def launch_args(m: int, n: int, g: int, elem: int,
                transpose_rhs: bool) -> Tuple[int, int, int, int]:
    """The forward: cdiv(M, BM) + G row tiles (an upper bound on what the
    groups and the zero tail take, whatever the sizes), cdiv(N, BN)
    column tiles, the ring for ``elem``-byte operands (rhs stages (BN, BK)
    read transposed, else (BK, BN))."""
    b = (BN, BK) if transpose_rhs else (BK, BN)
    return (blocks(m, BM) + g, blocks(n, BN), THREADS,
            ring_bytes(elem, (BM, BK), b, STAGES[elem]))


def launch_geometry(m: int, n: int, g: int, elem: int,
                    transpose_rhs: bool) -> Geometry:
    gx, gy, threads, smem = launch_args(m, n, g, elem, transpose_rhs)
    return Geometry(ENTRY, (gx, gy, 1), (threads, 1, 1), smem,
                    (Cover("rows (M), each group's last tile padded: "
                           "M + G x BM", 0, BM, m + g * BM),
                     Cover("columns (N)", 1, BN, n)))


def wgrad_args(k: int, n: int, g: int,
               elem: int) -> Tuple[int, int, int, int, int]:
    """The weight gradient: (cdiv(N, BN), cdiv(K, BM), G) blocks, one
    group's (K, N) tile each, the ring of (BK, BM) and (BK, BN) stages."""
    return (blocks(n, BN), blocks(k, BM), g, THREADS,
            ring_bytes(elem, (BK, BM), (BK, BN), WGRAD_STAGES))


def wgrad_geometry(k: int, n: int, g: int, elem: int) -> Geometry:
    gx, gy, gz, threads, smem = wgrad_args(k, n, g, elem)
    return Geometry(WGRAD_ENTRY, (gx, gy, gz), (threads, 1, 1), smem,
                    (Cover("columns (N)", 0, BN, n),
                     Cover("rows of a group's weight (K)", 1, BM, k),
                     Cover("groups (G)", 2, 1, g)))


def takes_tma(dtype: torch.dtype, m: int, k: int, n: int, *tensors) -> bool:
    """Whether a call takes the Hopper route: bf16, at least one row, K
    and N multiples of 8 (each row a whole number of 16-byte units, as a
    tensor map's strides must be) and every operand 16-byte aligned.
    Any other call (fp32, odd widths) takes the first route."""
    return (dtype == torch.bfloat16 and m > 0 and k > 0 and n > 0
            and k % 8 == 0 and n % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def tma_tables(sizes, m: int, rows: int = TMA_BM):
    """The kernel's group tables: each group's first row ``off[g]``
    (sizes clamped at 0, the running sum at M) and first tile of ``rows``
    rows ``tile[g]``, for g <= G + 1; the zero tail past the groups is
    group G (``off[G + 1] = M``)."""
    off, tile, at, t = [], [], 0, 0
    for size in list(sizes) + [m]:
        off.append(at)
        tile.append(t)
        end = min(at + max(int(size), 0), m)
        t += blocks(end - at, rows)
        at = end
    off.append(m)
    tile.append(t)
    return off, tile


def _persistent(tiles: int, sms: int) -> int:
    """One block an SM, never more blocks than tiles."""
    return max(1, min(tiles, TMA_BLOCKS_PER_SM * sms))


def tma_tiles(m: int, n: int, g: int) -> int:
    """The forward's tiles, bounded without the sizes: each group's row
    tiles and the zero tail's (at most cdiv(M, 128) + G, as cdiv(a) +
    cdiv(b) <= cdiv(a + b) + 1 over G + 1 terms) by cdiv(N, 256)."""
    return (blocks(m, TMA_BM) + g) * blocks(n, TMA_BN)


def tma_args(m: int, n: int, g: int, sms: int) -> Tuple[int, int, int]:
    """The Hopper forward's persistent grid: one block an SM, never more
    blocks than tiles; threads a block, dynamic shared memory."""
    return _persistent(tma_tiles(m, n, g), sms), TMA_THREADS, TMA_SMEM


def tma_walk(sizes, m: int, n: int, grid: int, rows: int = TMA_BM,
             cols: int = TMA_BN):
    """The Hopper forward's tiles as its blocks take them: block b takes
    tiles b, b + grid, ... of the linear index over (group, column tile,
    row tile), the zero tail last; yields (block, group, first row, the
    group's end row, first column). A tile's rows from its group's end on
    are not stored. ``rows`` and ``cols``: a tile's (the fp32 route's
    are TF32_BR and TF32_BN)."""
    g = len(sizes)
    off, tile = tma_tables(sizes, m, rows)
    ncol = blocks(n, cols)
    starts = [t * ncol for t in tile[:g + 1]]
    for b in range(grid):
        for t in range(b, tile[g + 1] * ncol, grid):
            grp = bisect.bisect_right(starts, t) - 1
            local = t - starts[grp]
            in_group = tile[grp + 1] - tile[grp]
            yield (b, grp, off[grp] + (local % in_group) * rows,
                   off[grp + 1], (local // in_group) * cols)


def tma_geometry(m: int, k: int, n: int, g: int, transpose_rhs: bool,
                 sms: int = H100_SMS) -> Geometry:
    grid, threads, smem = tma_args(m, n, g, sms)
    tiles = tma_tiles(m, n, g)
    rhs = (TensorMap("rhs (G, N, K)", (k, n, g), (2 * k, 2 * k * n))
           if transpose_rhs else
           TensorMap("rhs (G, K, N)", (n, k, g), (2 * n, 2 * n * k)))
    return Geometry(TMA_ENTRY, (grid, 1, 1), (threads, 1, 1), smem,
                    (Cover("tiles: (cdiv(M, 128) + G) row tiles x "
                           "cdiv(N, 256) column tiles", 0, 1, tiles,
                           passes=blocks(tiles, grid)),),
                    (TensorMap("lhs (M, K)", (k, m), (2 * k,)), rhs))


def tma_wgrad_tiles(k: int, n: int, g: int) -> int:
    """The Hopper weight gradient's tiles: G x cdiv(K, 128) x cdiv(N, 256)
    (every group's, an empty one's stored 0)."""
    return g * blocks(k, TMA_BM) * blocks(n, TMA_BN)


def tma_wgrad_args(k: int, n: int, g: int,
                   sms: int) -> Tuple[int, int, int]:
    return _persistent(tma_wgrad_tiles(k, n, g), sms), TMA_THREADS, TMA_SMEM


def tma_wgrad_walk(sizes, m: int, k: int, n: int, grid: int):
    """The Hopper weight gradient's tiles as its blocks take them: block b
    takes tiles b, b + grid, ... of the linear index over (group, K tile,
    N tile); yields (block, group, first K row, first column, the group's
    first and end rows)."""
    off, _ = tma_tables(sizes, m)
    nk, nn = blocks(k, TMA_BM), blocks(n, TMA_BN)
    for b in range(grid):
        for t in range(b, len(sizes) * nk * nn, grid):
            grp, local = divmod(t, nk * nn)
            yield (b, grp, (local // nn) * TMA_BM, (local % nn) * TMA_BN,
                   off[grp], off[grp + 1])


def tma_wgrad_geometry(m: int, k: int, n: int, g: int,
                       sms: int = H100_SMS) -> Geometry:
    grid, threads, smem = tma_wgrad_args(k, n, g, sms)
    tiles = tma_wgrad_tiles(k, n, g)
    return Geometry(TMA_WGRAD_ENTRY, (grid, 1, 1), (threads, 1, 1), smem,
                    (Cover("tiles: G x cdiv(K, 128) x cdiv(N, 256)", 0, 1,
                           tiles, passes=blocks(tiles, grid)),),
                    (TensorMap("lhs (M, K)", (k, m), (2 * k,)),
                     TensorMap("grad (M, N)", (n, m), (2 * n,))))


def takes_tf32(dtype: torch.dtype, m: int, k: int, n: int,
               *tensors) -> bool:
    """Whether a call takes the fp32 Hopper route: fp32, at least one
    row, K and N multiples of 4 (each row a whole number of 16-byte units,
    as a tensor map's strides must be) and every operand 16-byte aligned.
    Other fp32 calls take the first route."""
    return (dtype == torch.float32 and m > 0 and k > 0 and n > 0
            and k % 4 == 0 and n % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def tf32_k_pad(k: int) -> int:
    """The split planes' row length: K padded to whole 32-deep stages."""
    return blocks(k, TF32_BK) * TF32_BK


def tf32_tiles(m: int, n: int, g: int) -> int:
    """The fp32 forward's tiles, bounded without the sizes: (cdiv(M, 144)
    + G) row tiles by cdiv(N, 128) column tiles."""
    return (blocks(m, TF32_BR) + g) * blocks(n, TF32_BN)


def tf32_args(m: int, n: int, g: int, sms: int) -> Tuple[int, int, int]:
    """The fp32 forward's persistent grid: one block an SM, never more
    blocks than tiles; threads a block, dynamic shared memory."""
    return _persistent(tf32_tiles(m, n, g), sms), TMA_THREADS, TF32_SMEM


def tf32_walk(sizes, m: int, n: int, grid: int):
    """The fp32 forward's tiles as its blocks take them, as ``tma_walk``
    with its 144-row, 128-column tiles; a tile's rows, rounded up to 16,
    are wgmma's N."""
    return tma_walk(sizes, m, n, grid, TF32_BR, TF32_BN)


def tf32_geometry(m: int, k: int, n: int, g: int, transpose_rhs: bool,
                  sms: int = H100_SMS) -> Geometry:
    grid, threads, smem = tf32_args(m, n, g, sms)
    tiles = tf32_tiles(m, n, g)
    kp = tf32_k_pad(k)
    rhs = (TensorMap("rhs (G, N, K)", (k, n, g), (4 * k, 4 * k * n))
           if transpose_rhs else
           TensorMap("rhs (G, K, N)", (n, k, g), (4 * n, 4 * n * k)))
    return Geometry(TF32_ENTRY, (grid, 1, 1), (threads, 1, 1), smem,
                    (Cover("tiles: (cdiv(M, 144) + G) row tiles x "
                           "cdiv(N, 128) column tiles", 0, 1, tiles,
                           passes=blocks(tiles, grid)),),
                    (TensorMap("lhs planes (2, M, Kp)", (kp, m, 2),
                               (4 * kp, 4 * kp * m)), rhs))


def tf32_m_pad(m: int, g: int) -> int:
    """The transposed planes' columns: each group's rows padded to whole
    32-row stages fit in 32 (cdiv(M, 32) + G), whatever the sizes."""
    return TF32_TN * (blocks(m, TF32_TN) + g)


def tf32_wgrad_split_args(m: int, k: int, n: int,
                          g: int) -> Tuple[int, int, int, int, int]:
    """The weight gradient's transposing split of lhs (M, K) and grad
    (M, N) into (2, K, Mpad) and (2, N, Mpad) planes: x over Mpad in
    TF32_TN (cdiv(M, 32) + G blocks, past y's 65535 from about 2.1M
    rows), y over the wider operand's columns in TF32_TJ, z the two
    operands."""
    return (tf32_m_pad(m, g) // TF32_TN, blocks(max(k, n), TF32_TJ), 2,
            TF32_SPLIT_T_THREADS, 0)


def tf32_wgrad_split_geometry(m: int, k: int, n: int, g: int) -> Geometry:
    gx, gy, gz, threads, smem = tf32_wgrad_split_args(m, k, n, g)
    return Geometry(TF32_WGRAD_SPLIT_ENTRY, (gx, gy, gz), (threads, 1, 1),
                    smem,
                    (Cover("padded rows (32 (cdiv(M, 32) + G))", 0, TF32_TN,
                           tf32_m_pad(m, g)),
                     Cover("columns of lhs or grad (max(K, N))", 1, TF32_TJ,
                           max(k, n)),
                     Cover("operands (lhs, grad)", 2, 1, 2)))


def tf32_wgrad_tables(sizes, m: int):
    """The transposed planes' layout: group g's rows at columns
    ``32 tile[g]`` .. + its rows, zero to the next multiple of 32, its
    stages ``tile[g + 1] - tile[g]`` (``tma_tables`` at 32 rows)."""
    return tma_tables(sizes, m, TF32_TN)


def tf32_wgrad_tiles(k: int, n: int, g: int) -> int:
    """The fp32 weight gradient's tiles: G x cdiv(K, 128) x cdiv(N, 128)
    (every group's, an empty one's stored 0)."""
    return g * blocks(k, TF32_WG_BM) * blocks(n, TF32_WG_BN)


def tf32_wgrad_args(k: int, n: int, g: int,
                    sms: int) -> Tuple[int, int, int]:
    return (_persistent(tf32_wgrad_tiles(k, n, g), sms), TMA_THREADS,
            TF32_WG_SMEM)


def tf32_wgrad_walk(sizes, m: int, k: int, n: int, grid: int):
    """The fp32 weight gradient's tiles as its blocks take them: block b
    takes tiles b, b + grid, ... of the linear index over (group, K tile,
    N tile); yields (block, group, first K row, first column, the group's
    first padded column, its stages)."""
    off, tile = tf32_wgrad_tables(sizes, m)
    nk, nn = blocks(k, TF32_WG_BM), blocks(n, TF32_WG_BN)
    for b in range(grid):
        for t in range(b, len(sizes) * nk * nn, grid):
            grp, local = divmod(t, nk * nn)
            yield (b, grp, (local // nn) * TF32_WG_BM,
                   (local % nn) * TF32_WG_BN, TF32_TN * tile[grp],
                   tile[grp + 1] - tile[grp])


def tf32_wgrad_geometry(m: int, k: int, n: int, g: int,
                        sms: int = H100_SMS) -> Geometry:
    grid, threads, smem = tf32_wgrad_args(k, n, g, sms)
    tiles = tf32_wgrad_tiles(k, n, g)
    mp = tf32_m_pad(m, g)
    return Geometry(TF32_WGRAD_ENTRY, (grid, 1, 1), (threads, 1, 1), smem,
                    (Cover("tiles: G x cdiv(K, 128) x cdiv(N, 128)", 0, 1,
                           tiles, passes=blocks(tiles, grid)),),
                    (TensorMap("lhs^T planes (2, K, Mpad)", (mp, k, 2),
                               (4 * mp, 4 * mp * k)),
                     TensorMap("grad^T planes (2, N, Mpad)", (mp, n, 2),
                               (4 * mp, 4 * mp * n))))


def _shapes(lhs, rhs, group_sizes, transpose_rhs: bool):
    """(M, K, N, G) of a forward call; raises on shapes that disagree."""
    if lhs.dim() != 2 or rhs.dim() != 3 or group_sizes.dim() != 1 \
            or group_sizes.shape[0] != rhs.shape[0] \
            or lhs.shape[1] != rhs.shape[2 if transpose_rhs else 1]:
        raise ValueError(
            f"expected lhs (M,K), rhs (G,{'N,K' if transpose_rhs else 'K,N'})"
            f" and group_sizes (G,), got {tuple(lhs.shape)}, "
            f"{tuple(rhs.shape)} and {tuple(group_sizes.shape)}")
    if lhs.dtype != rhs.dtype:
        raise TypeError(f"lhs and rhs must share a dtype, got {lhs.dtype} "
                        f"and {rhs.dtype}")
    if group_sizes.is_floating_point() or group_sizes.is_complex():
        raise TypeError(f"group_sizes must be integers, got "
                        f"{group_sizes.dtype}")
    m, k = lhs.shape
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    return m, k, n, rhs.shape[0]


def _check_card(what: str, *tensors) -> None:
    """The kernels' terms: one CUDA device, fp32 or bf16 operands, int32
    group sizes (the last tensor), contiguous, at most MAX_GROUPS."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: the operands must be on one CUDA device, "
                         f"got {sorted(map(str, devices))}")
    *operands, sizes = tensors
    if operands[0].dtype not in DTYPES:
        raise TypeError(f"{what}: operands must be float32 or bfloat16, got "
                        f"{operands[0].dtype}")
    if sizes.dtype != torch.int32:
        raise TypeError(f"{what}: group_sizes must be int32 on the card, got "
                        f"{sizes.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: the operands must be contiguous")
    if sizes.shape[0] > MAX_GROUPS:
        raise ValueError(f"{what}: the kernel takes at most {MAX_GROUPS} "
                         f"groups, got {sizes.shape[0]}")


# ---------------------------------------------------------------------------
# the forward op
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::ragged_dot", mutates_args=(),
                         device_types="cpu")
def ragged_dot(lhs: torch.Tensor, rhs: torch.Tensor,
               group_sizes: torch.Tensor,
               transpose_rhs: bool) -> torch.Tensor:
    """``jax.lax.ragged_dot(lhs, rhs, group_sizes)`` (``transpose_rhs``:
    against each group's rhs transposed), differentiable in lhs and rhs;
    on the CPU the plain version."""
    _shapes(lhs, rhs, group_sizes, transpose_rhs)
    return plain(lhs, rhs, group_sizes, transpose_rhs)


@ragged_dot.register_kernel("cuda")
def _ragged_dot_cuda(lhs, rhs, group_sizes, transpose_rhs):
    m, k, n, g = _shapes(lhs, rhs, group_sizes, transpose_rhs)
    _check_card("ragged_dot", lhs, rhs, group_sizes)
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    if m == 0 or n == 0:
        return out
    if g == 0:
        return out.zero_()
    global launches, tma_launches
    ptrs = (lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr())
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    if takes_tma(lhs.dtype, m, k, n, lhs, rhs, out):
        fn = build.entry(SOURCE, TMA_ENTRY, *ENTRIES[TMA_ENTRY])
        code = fn(*ptrs, m, k, n, g, int(transpose_rhs),
                  *tma_args(m, n, g, num_sms(lhs.device)), stream)
        build.check(TMA_ENTRY, code)
        tma_launches += 1
    elif takes_tf32(lhs.dtype, m, k, n, lhs, rhs, out):
        _tf32_forward(lhs, rhs, group_sizes, out, transpose_rhs, stream)
    else:
        fn = build.entry(SOURCE, ENTRY, *ENTRIES[ENTRY])
        code = fn(*ptrs, m, k, n, g, int(lhs.dtype == torch.bfloat16),
                  int(transpose_rhs),
                  *launch_args(m, n, g, lhs.element_size(), transpose_rhs),
                  stream)
        build.check(ENTRY, code)
    launches += 1
    return out


def _count_tf32_split() -> None:
    global tf32_split_launches
    tf32_split_launches += 1


def tf32_split(lhs: torch.Tensor) -> torch.Tensor:
    """The fp32 forward's split on the card: lhs (M, K) fp32 -> planes
    (2, M, Kp), hi = tf32(lhs), lo = tf32(lhs - hi), zero past K, by B1's
    split pass in its B-side mode (its plain version:
    ``ref.pairwise_kl_split_ref``); counted here, not in B1's count."""
    return pk.split(lhs.unsqueeze(-1), False, count=_count_tf32_split).planes


def tf32_wgrad_split(lhs: torch.Tensor, grad: torch.Tensor,
                     group_sizes: torch.Tensor):
    """The fp32 weight gradient's transposing split on the card: lhs (M,
    K) and grad (M, N) fp32 -> planes (2, K, Mpad) and (2, N, Mpad), each
    group's rows from a 32-column boundary, zero to the next (its plain
    version: ``ref.ragged_dot_wgrad_tf32_split_ref``; the columns past the
    groups' are not written)."""
    global tf32_wgrad_split_launches
    m, k = lhs.shape
    n, g = grad.shape[1], group_sizes.shape[0]
    mp = tf32_m_pad(m, g)
    lhs_t = torch.empty((2, k, mp), dtype=torch.float32, device=lhs.device)
    grad_t = torch.empty((2, n, mp), dtype=torch.float32, device=lhs.device)
    fn = build.entry(TF32_SOURCE, TF32_WGRAD_SPLIT_ENTRY,
                     *TF32_ENTRIES[TF32_WGRAD_SPLIT_ENTRY])
    build.check(TF32_WGRAD_SPLIT_ENTRY,
                fn(lhs.data_ptr(), grad.data_ptr(), group_sizes.data_ptr(),
                   lhs_t.data_ptr(), grad_t.data_ptr(), m, k, n, g, mp,
                   *tf32_wgrad_split_args(m, k, n, g),
                   torch.cuda.current_stream(lhs.device).cuda_stream))
    tf32_wgrad_split_launches += 1
    return lhs_t, grad_t


def _tf32_forward(lhs, rhs, group_sizes, out, transpose_rhs, stream):
    """The fp32 Hopper route's two launches: lhs's hi/lo planes, then the
    grouped 3xTF32 product over them."""
    global tf32_launches
    m, k = lhs.shape
    n, g = out.shape[1], rhs.shape[0]
    planes = tf32_split(lhs)
    fn = build.entry(TF32_SOURCE, TF32_ENTRY, *TF32_ENTRIES[TF32_ENTRY])
    build.check(TF32_ENTRY, fn(planes.data_ptr(), rhs.data_ptr(),
                               group_sizes.data_ptr(), out.data_ptr(), m, k,
                               n, g, int(transpose_rhs),
                               *tf32_args(m, n, g, num_sms(lhs.device)),
                               stream))
    tf32_launches += 1


@ragged_dot.register_fake
def _ragged_dot_fake(lhs, rhs, group_sizes, transpose_rhs):
    m, _, n, _ = _shapes(lhs, rhs, group_sizes, transpose_rhs)
    return lhs.new_empty((m, n))


# ---------------------------------------------------------------------------
# the weight-gradient op
# ---------------------------------------------------------------------------

def _wgrad_shapes(lhs, grad, group_sizes):
    """(M, K, N, G) of a weight-gradient call; raises on shapes that
    disagree."""
    if lhs.dim() != 2 or grad.dim() != 2 or group_sizes.dim() != 1 \
            or lhs.shape[0] != grad.shape[0]:
        raise ValueError(f"expected lhs (M,K), grad (M,N) and group_sizes "
                         f"(G,), got {tuple(lhs.shape)}, {tuple(grad.shape)} "
                         f"and {tuple(group_sizes.shape)}")
    if lhs.dtype != grad.dtype:
        raise TypeError(f"lhs and grad must share a dtype, got {lhs.dtype} "
                        f"and {grad.dtype}")
    return lhs.shape[0], lhs.shape[1], grad.shape[1], group_sizes.shape[0]


@torch.library.custom_op("repro_torch::ragged_dot_wgrad", mutates_args=(),
                         device_types="cpu")
def ragged_dot_wgrad(lhs: torch.Tensor, grad: torch.Tensor,
                     group_sizes: torch.Tensor) -> torch.Tensor:
    """The weight gradient of ``ragged_dot``: lhs (M,K), grad (M,N) ->
    (G,K,N), group g's lhs rows transposed times its grad rows; on the
    CPU the plain version."""
    _wgrad_shapes(lhs, grad, group_sizes)
    return plain_wgrad(lhs, grad, group_sizes)


@ragged_dot_wgrad.register_kernel("cuda")
def _ragged_dot_wgrad_cuda(lhs, grad, group_sizes):
    m, k, n, g = _wgrad_shapes(lhs, grad, group_sizes)
    _check_card("ragged_dot_wgrad", lhs, grad, group_sizes)
    out = torch.empty((g, k, n), dtype=lhs.dtype, device=lhs.device)
    if out.numel() == 0:
        return out
    global wgrad_launches, tma_wgrad_launches
    ptrs = (lhs.data_ptr(), grad.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr())
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    if takes_tma(lhs.dtype, m, k, n, lhs, grad, out):
        fn = build.entry(SOURCE, TMA_WGRAD_ENTRY, *ENTRIES[TMA_WGRAD_ENTRY])
        code = fn(*ptrs, m, k, n, g,
                  *tma_wgrad_args(k, n, g, num_sms(lhs.device)), stream)
        build.check(TMA_WGRAD_ENTRY, code)
        tma_wgrad_launches += 1
    elif takes_tf32(lhs.dtype, m, k, n, lhs, grad, out):
        _tf32_wgrad(lhs, grad, group_sizes, out, stream)
    else:
        fn = build.entry(SOURCE, WGRAD_ENTRY, *ENTRIES[WGRAD_ENTRY])
        code = fn(*ptrs, m, k, n, g, int(lhs.dtype == torch.bfloat16),
                  *wgrad_args(k, n, g, lhs.element_size()), stream)
        build.check(WGRAD_ENTRY, code)
    wgrad_launches += 1
    return out


def _tf32_wgrad(lhs, grad, group_sizes, out, stream):
    """The fp32 Hopper route's two launches: lhs's and grad's transposed
    hi/lo planes, each group on whole 32-row stages, then the grouped
    3xTF32 product over them."""
    global tf32_wgrad_launches
    m, k = lhs.shape
    n, g = grad.shape[1], group_sizes.shape[0]
    mp = tf32_m_pad(m, g)
    lhs_t, grad_t = tf32_wgrad_split(lhs, grad, group_sizes)
    fn = build.entry(TF32_SOURCE, TF32_WGRAD_ENTRY,
                     *TF32_ENTRIES[TF32_WGRAD_ENTRY])
    build.check(TF32_WGRAD_ENTRY,
                fn(lhs_t.data_ptr(), grad_t.data_ptr(),
                   group_sizes.data_ptr(), out.data_ptr(), m, k, n, g, mp,
                   *tf32_wgrad_args(k, n, g, num_sms(lhs.device)), stream))
    tf32_wgrad_launches += 1


@ragged_dot_wgrad.register_fake
def _ragged_dot_wgrad_fake(lhs, grad, group_sizes):
    _, k, n, g = _wgrad_shapes(lhs, grad, group_sizes)
    return lhs.new_empty((g, k, n))


# ---------------------------------------------------------------------------
# autograd and FLOPs
# ---------------------------------------------------------------------------

def _setup_context(ctx, inputs, output):
    lhs, rhs, group_sizes, transpose_rhs = inputs
    ctx.save_for_backward(lhs, rhs, group_sizes)
    ctx.transpose_rhs = transpose_rhs


def _backward(ctx, grad):
    """d_lhs is the forward of grad on rhs read the other way round; the
    weight gradient sums each group's rows (grad^T lhs when rhs was read
    transposed). Rows past the groups get 0, empty groups 0."""
    lhs, rhs, group_sizes = ctx.saved_tensors
    grad = grad.contiguous()
    d_lhs = d_rhs = None
    if ctx.needs_input_grad[0]:
        d_lhs = ragged_dot(grad, rhs, group_sizes, not ctx.transpose_rhs)
    if ctx.needs_input_grad[1]:
        d_rhs = (ragged_dot_wgrad(grad, lhs, group_sizes)
                 if ctx.transpose_rhs
                 else ragged_dot_wgrad(lhs, grad, group_sizes))
    return d_lhs, d_rhs, None, None


ragged_dot.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula(torch.ops.repro_torch.ragged_dot)
def _ragged_dot_flops(lhs_shape, rhs_shape, sizes_shape, *args,
                      out_shape=None, **kwargs) -> int:
    """2 M K N, as if every row met every group's weights once: the
    reference's ``hlo_cost`` count of ``ragged-dot``."""
    m, k = lhs_shape
    return 2 * m * k * out_shape[1]


@register_flop_formula(torch.ops.repro_torch.ragged_dot_wgrad)
def _ragged_dot_wgrad_flops(lhs_shape, grad_shape, sizes_shape, *args,
                            out_shape=None, **kwargs) -> int:
    """2 M K N: every row's outer product, summed into its group."""
    m, k = lhs_shape
    return 2 * m * k * grad_shape[1]
