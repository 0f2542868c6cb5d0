"""The port's grouped product (``kernels/ragged_dot.py``) against
``jax.lax.ragged_dot``, on the CPU (the plain version; the CUDA kernels
run in ``tests/test_torch_gpu_ragged_dot.py`` and ``chip_smoke.py``):

  * the forward and the vjp (both cotangents) in fp32 and bf16, with empty
    groups, rows past the groups' sum and a single group;
  * the custom ops' fake shapes (a step on fake tensors traces them), and
    their FLOPs inside ``FlopCounterMode``: 2 M K N a product, the
    reference's ``hlo_cost`` count;
  * the op's autograd against autograd through the plain per-group loop
    the dropless FFN ran before, bit for bit;
  * the dropless FFN's forward and backward on fake tensors, which cannot
    be read on the host: no host sync is left on the path;
  * the Hopper route's tile walks (the Python twins of the kernels'),
    which must store every output row, the zero tail included, and every
    weight-gradient tile exactly once, and its choice by dtype,
    alignment and widths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_kl as pk
from repro_torch.kernels import ragged_dot as rd
from repro_torch.kernels import ref

M, K, N = 23, 12, 10
# group sizes: two empty groups and 3 rows past the sum; all rows in one
# group; a single group covering fewer rows than M
CASES = {"empty_and_past": [5, 0, 9, 0, 6], "one_of_many": [0, 0, 23, 0],
         "single": [17]}
# bf16: the two packages round the same fp32 sums once; a sum that lands
# near a rounding boundary may round the other way (one bf16 ulp, 2^-8
# of its magnitude) where the summation order differs
BF16_ULP = 2.0 ** -8


def _inputs(sizes, dtype, seed=0):
    rng = np.random.default_rng(seed)
    g = len(sizes)
    lhs = rng.normal(size=(M, K)).astype(np.float32)
    rhs = rng.normal(size=(g, K, N)).astype(np.float32)
    dout = rng.normal(size=(M, N)).astype(np.float32)
    if dtype == "bfloat16":       # values exact in bf16, both sides
        lhs, rhs, dout = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                          for a in (lhs, rhs, dout))
    return lhs, rhs, np.asarray(sizes, np.int32), dout


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, dtype, scale):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP,
                                   atol=BF16_ULP * 1e-2 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_dot_matches_jax_forward_and_vjp(case, dtype):
    lhs, rhs, sizes, dout = _inputs(CASES[case], dtype)
    jdt = getattr(jnp, dtype)
    out, vjp = jax.vjp(
        lambda a, b: jax.lax.ragged_dot(a, b, jnp.asarray(sizes)),
        jnp.asarray(lhs, jdt), jnp.asarray(rhs, jdt))
    d_lhs, d_rhs = vjp(jnp.asarray(dout, jdt))
    tl = _torch(lhs, dtype).requires_grad_()
    tr = _torch(rhs, dtype).requires_grad_()
    got = ops.ragged_dot(tl, tr, torch.from_numpy(sizes))
    got.backward(_torch(dout, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (M, N)
    assert tl.grad.dtype == got.dtype and tr.grad.dtype == got.dtype
    used = int(min(sizes.sum(), M))
    # rows past the groups: 0 out and 0 gradient, in both packages
    assert not got[used:].any() and not tl.grad[used:].any()
    assert not np.asarray(out, np.float32)[used:].any()
    scale = float(np.sqrt(K))         # the sums' typical magnitude
    _close(got.detach(), out.astype(jnp.float32), dtype, scale)
    _close(tl.grad, d_lhs.astype(jnp.float32), dtype, scale)
    _close(tr.grad, d_rhs.astype(jnp.float32), dtype, float(np.sqrt(M)))
    for g, size in enumerate(sizes):        # an empty group's grad is 0
        if size == 0:
            assert not tr.grad[g].any()


def test_wgrad_entry_and_transposed_forward_match_jax():
    lhs, rhs, sizes, dout = _inputs(CASES["empty_and_past"], "float32", 1)
    _, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, sizes),
                     jnp.asarray(lhs), jnp.asarray(rhs))
    d_lhs, d_rhs = vjp(jnp.asarray(dout))
    ts = torch.from_numpy(sizes)
    wgrad = ops.ragged_dot_wgrad(torch.from_numpy(lhs),
                                 torch.from_numpy(dout), ts)
    np.testing.assert_allclose(wgrad.numpy(), d_rhs, rtol=0,
                               atol=1e-5 * np.sqrt(M))
    # the input gradient reads rhs (G,K,N) transposed in place
    d_in = ops.ragged_dot(torch.from_numpy(dout), torch.from_numpy(rhs), ts,
                          transpose_rhs=True)
    np.testing.assert_allclose(d_in.numpy(), d_lhs, rtol=0,
                               atol=1e-5 * np.sqrt(N))


def test_fake_shapes_and_flop_formula():
    g = 5
    with FakeTensorMode():
        lhs = torch.empty(M, K, dtype=torch.bfloat16)
        rhs = torch.empty(g, K, N, dtype=torch.bfloat16)
        sizes = torch.empty(g, dtype=torch.int32)
        out = ops.ragged_dot(lhs, rhs, sizes)
        assert out.shape == (M, N) and out.dtype == torch.bfloat16
        back = ops.ragged_dot(out, rhs, sizes, transpose_rhs=True)
        assert back.shape == (M, K)
        wg = ops.ragged_dot_wgrad(lhs, out, sizes)
        assert wg.shape == (g, K, N) and wg.dtype == torch.bfloat16
        with pytest.raises(ValueError):
            ops.ragged_dot(lhs, rhs[:, :, :3].transpose(1, 2), sizes)
    lhs, rhs, sizes, dout = _inputs(CASES["empty_and_past"], "float32")
    tl = torch.from_numpy(lhs).requires_grad_()
    tr = torch.from_numpy(rhs).requires_grad_()
    with FlopCounterMode(display=False) as fc:
        ops.ragged_dot(tl, tr, torch.from_numpy(sizes)).backward(
            torch.from_numpy(dout))
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    # forward, input gradient, weight gradient: 2 M K N each
    assert counts == {"repro_torch.ragged_dot": 2 * (2 * M * K * N),
                      "repro_torch.ragged_dot_wgrad": 2 * M * K * N}


def _loop(lhs, w_unbound, sizes):
    """The dropless FFN's former per-group loop: one product a nonempty
    group, concatenated (every row in some group)."""
    outs, start = [], 0
    for i, n in enumerate(sizes):
        if n:
            outs.append(lhs[start:start + n] @ w_unbound[i])
            start += n
    return torch.cat(outs)


def test_autograd_equals_the_plain_loops_bit_for_bit():
    sizes = [7, 0, 11, 5]                  # every row in a group, as there
    rng = np.random.default_rng(3)
    x = rng.normal(size=(sum(sizes), K)).astype(np.float32)
    w = rng.normal(size=(len(sizes), K, N)).astype(np.float32)
    dy = torch.from_numpy(rng.normal(size=(sum(sizes), N)).astype(np.float32))
    runs = []
    for op in (True, False):
        tx = torch.from_numpy(x).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        y = ops.ragged_dot(tx, tw, torch.tensor(sizes, dtype=torch.int32)) \
            if op else _loop(tx, tw.unbind(0), sizes)
        y.backward(dy)
        runs.append((y.detach(), tx.grad, tw.grad))
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def test_dropless_ffn_runs_on_fake_tensors():
    """The dropless FFN's forward and backward at a reduced config on fake
    tensors: a ``.tolist()`` or ``.item()`` on the path would raise."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.ffn import init_moe, moe_dropless_forward
    from repro_torch.models.common import Init
    cfg = get_reduced("deepseek-v2-236b")
    with FakeTensorMode():
        p = init_moe(Init(None, torch.device("cpu")), cfg)
        for v in p.values():
            if isinstance(v, torch.Tensor):
                v.requires_grad_()
        x = torch.randn(2, 5, cfg.d_model, dtype=cfg.param_dtype,
                        requires_grad=True)
        y, aux = moe_dropless_forward(p, cfg, x)
        (y.float().sum() + aux).backward()
        assert y.shape == x.shape and x.grad.shape == x.shape
        assert p["w_down"].grad.shape == p["w_down"].shape


def test_kernel_geometry_and_card_checks():
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "ragged_dot.cu").read_text()

    def constexpr(name):
        return int(re.search(r"constexpr int " + name + r" = (\d+);",
                             src).group(1))
    # the entry points refuse any launch but launch_args' own
    assert (constexpr("BM"), constexpr("BN"), constexpr("BK"),
            constexpr("THREADS"), constexpr("MAX_GROUPS")) == (
        rd.BM, rd.BN, rd.BK, rd.THREADS, rd.MAX_GROUPS)
    stages = re.findall(r"struct Ring<(\w+)> \{\s*static constexpr int "
                        r"STAGES = (\d+);", src)
    assert {2 if t == "__nv_bfloat16" else 4: int(n)
            for t, n in stages} == rd.STAGES
    assert constexpr("WGRAD_STAGES") == rd.WGRAD_STAGES
    # the forward's grid: one row tile more a group than cdiv(M, BM); a
    # bf16 ring of 4 stages, each a 64 x (32 + 8) lhs tile and a
    # 32 x (128 + 8) rhs tile (13824 bytes)
    gx, gy, threads, smem = rd.launch_args(257, 131, 160, 2, False)
    assert (gx, gy, threads, smem) == (5 + 160, 2, rd.THREADS, 4 * 13824)
    assert rd.wgrad_args(21, 131, 7, 4)[:4] == (2, 1, 7, rd.THREADS)
    # the Hopper route's tile, stages, threads and shared memory: a ring
    # of 4 stages of a 128 x 64 lhs tile and a 64 x 256 rhs tile, 1024
    # bytes to align; its persistent grids: one block an SM, never more
    # blocks than the tiles' bound
    assert (constexpr("TMA_BM"), constexpr("TMA_BN"), constexpr("TMA_BK"),
            constexpr("TMA_STAGES"), constexpr("TMA_THREADS"),
            constexpr("TMA_SMEM")) == (
        rd.TMA_BM, rd.TMA_BN, rd.TMA_BK, rd.TMA_STAGES, rd.TMA_THREADS,
        rd.TMA_SMEM) == (128, 256, 64, 4, 384, 4 * 49152 + 1024)
    assert rd.tma_args(512, 14336, 8, 132) == (132, 384, rd.TMA_SMEM)
    assert rd.tma_tiles(257, 136, 7) == (3 + 7) * 1
    assert rd.tma_args(257, 136, 7, 132)[0] == 10
    assert rd.tma_wgrad_args(24, 136, 160, 132)[0] == 132
    lhs, rhs, sizes, _ = _inputs(CASES["single"], "float32")
    # mixed dtypes are refused before any device dispatch
    with pytest.raises(TypeError):
        ops.ragged_dot(torch.from_numpy(lhs).double(), torch.from_numpy(rhs),
                       torch.from_numpy(sizes))


# --------------------------------------------------------------------------
# the Hopper route: its tile walks and its choice
# --------------------------------------------------------------------------

def _walk_sizes(g: int, seed: int):
    """(M, group sizes): random sizes with empty groups, summing to fewer
    rows than M (a zero tail); 1024 groups mostly empty."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 300 if g < 100 else 12, g)
    sizes[rng.random(g) < 0.3] = 0
    if g > 2:
        sizes[0] = sizes[-1] = 0
    return int(sizes.sum()) + 37, sizes


@pytest.mark.parametrize("g", [1, 7, 160, 1024])
def test_tma_walk_stores_every_row_once(g):
    """The forward's walk over (group, column tile, row tile) on a
    persistent grid smaller than the tiles (several passes): each row of
    each column tile is stored by exactly one tile's warpgroup, the zero
    tail's rows included, and no more tiles run than the bound the grid
    was sized from."""
    m, sizes = _walk_sizes(g, g)
    n = 8 * 67                                   # 3 column tiles
    ncol = -(-n // rd.TMA_BN)
    grid = 5
    stored = np.zeros((m, ncol), np.int64)
    tiles = list(rd.tma_walk(sizes, m, n, grid))
    for block, grp, r0, rend, n0 in tiles:
        assert 0 <= grp <= g and n0 % rd.TMA_BN == 0 and n0 < n
        for half in range(rd.TMA_BM // 64):     # a consumer warpgroup each
            lo = r0 + 64 * half
            stored[lo:max(lo, min(lo + 64, rend)), n0 // rd.TMA_BN] += 1
    assert (stored == 1).all()
    assert len(tiles) <= rd.tma_tiles(m, n, g)
    assert len(tiles) > grid                     # more than one pass
    # each block takes every grid-th tile of the walk, in order
    blocks = [t[0] for t in tiles]
    assert blocks == sorted(blocks)
    # the zero tail is group g: rows from the sum on
    tail = [t for t in tiles if t[1] == g]
    assert min(t[2] for t in tail) == int(sizes.sum())


@pytest.mark.parametrize("g", [1, 7, 160, 1024])
def test_tma_wgrad_walk_takes_every_tile_once(g):
    """The weight gradient's walk: every (group, K tile, N tile) exactly
    once, an empty group's too (it stores 0), each summing its group's
    rows only: [rbeg, rend) the groups' disjoint row ranges in order."""
    m, sizes = _walk_sizes(g, g + 1)
    k, n = 8 * 45, 8 * 40                        # 3 K tiles, 2 N tiles
    grid = 4
    seen = {}
    for block, grp, k0, n0, rbeg, rend in rd.tma_wgrad_walk(sizes, m, k, n,
                                                            grid):
        key = (grp, k0, n0)
        assert key not in seen and k0 < k and n0 < n
        seen[key] = (rbeg, rend)
    nk, nn = -(-k // rd.TMA_BM), -(-n // rd.TMA_BN)
    assert len(seen) == g * nk * nn == rd.tma_wgrad_tiles(k, n, g)
    ends = np.cumsum(np.clip(sizes, 0, None))
    for (grp, _, _), (rbeg, rend) in seen.items():
        assert (rbeg, rend) == (int(ends[grp] - sizes[grp]), int(ends[grp]))


def test_tma_tables_clamp_like_the_plain_version():
    """Negative sizes count as 0 and the running sum stops at M, as
    ``ragged_dot_ref`` reads them; the zero tail is one more group."""
    off, tile = rd.tma_tables([5, -3, 300, 4], 200)
    assert off == [0, 5, 5, 200, 200, 200]
    assert tile == [0, 1, 1, 3, 3, 3]
    off, tile = rd.tma_tables([0, 130], 300)
    assert off == [0, 0, 130, 300] and tile == [0, 0, 2, 4]


def test_route_follows_dtype_alignment_and_widths():
    """The Hopper route takes bf16 whose K and N are multiples of 8 and
    whose operands are 16-byte aligned; fp32, odd widths, a misaligned
    operand and an empty lhs take the first route."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)

    lhs, rhs = t(40, 64), t(3, 64, 136)
    assert rd.takes_tma(torch.bfloat16, 40, 64, 136, lhs, rhs)
    assert not rd.takes_tma(torch.float32, 40, 64, 136,
                            t(40, 64, dtype=torch.float32),
                            t(3, 64, 136, dtype=torch.float32))
    for k, n in ((21, 136), (64, 131), (12, 136), (64, 4)):
        assert not rd.takes_tma(torch.bfloat16, 40, k, n, t(40, k),
                                t(3, k, n))
    shifted = t(40 * 64 + 1)[1:].view(40, 64)    # 2 bytes off 16
    assert shifted.data_ptr() % 16 == 2
    assert not rd.takes_tma(torch.bfloat16, 40, 64, 136, shifted, rhs)
    assert not rd.takes_tma(torch.bfloat16, 0, 64, 136, t(0, 64), rhs)


# --------------------------------------------------------------------------
# the fp32 Hopper route (csrc/ragged_dot_tf32.cu): its choice, its tile
# walks, its padded layout and its 3xTF32 arithmetic
# --------------------------------------------------------------------------

def test_tf32_route_follows_dtype_alignment_and_widths():
    """The fp32 Hopper route takes fp32 whose K and N are multiples of 4
    and whose operands are 16-byte aligned; odd widths, a misaligned
    operand and an empty lhs take the first route; bf16 keeps
    ``takes_tma``'s choice and never takes this one."""
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    lhs, rhs = t(40, 64), t(3, 64, 136)
    assert rd.takes_tf32(torch.float32, 40, 64, 136, lhs, rhs)
    assert rd.takes_tf32(torch.float32, 40, 24, 20, t(40, 24), t(3, 24, 20))
    for k, n in ((21, 136), (64, 131), (6, 136), (64, 2)):
        assert not rd.takes_tf32(torch.float32, 40, k, n, t(40, k),
                                 t(3, k, n))
    shifted = t(40 * 64 + 1)[1:].view(40, 64)    # 4 bytes off 16
    assert shifted.data_ptr() % 16 == 4
    assert not rd.takes_tf32(torch.float32, 40, 64, 136, shifted, rhs)
    assert not rd.takes_tf32(torch.float32, 0, 64, 136, t(0, 64), rhs)
    b16 = (t(40, 64, dtype=torch.bfloat16), t(3, 64, 136,
                                               dtype=torch.bfloat16))
    assert not rd.takes_tf32(torch.bfloat16, 40, 64, 136, *b16)
    assert rd.takes_tma(torch.bfloat16, 40, 64, 136, *b16)
    assert not rd.takes_tma(torch.float32, 40, 64, 136, lhs, rhs)


def test_tf32_constants_are_the_sources():
    """The fp32 route's tiles, rings, threads and shared memory restate
    csrc/ragged_dot_tf32.cu's constants (its entry points refuse any
    other launch); its grids: one block an SM, never more than the
    tiles' bound."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "ragged_dot_tf32.cu").read_text()

    def constexpr(name):
        return int(re.search(r"constexpr int " + name + r" = (\d+);",
                             src).group(1))
    assert (constexpr("BK"), constexpr("FWD_BN"), constexpr("FWD_BR"),
            constexpr("ROW_STEP"), constexpr("FWD_STAGES"),
            constexpr("FWD_SMEM"), constexpr("WG_BM"), constexpr("WG_BN"),
            constexpr("WG_STAGES"), constexpr("WG_SMEM"),
            constexpr("THREADS"), constexpr("MAX_GROUPS"),
            constexpr("TN"), constexpr("TJ"),
            constexpr("SPLIT_T_THREADS")) == (
        rd.TF32_BK, rd.TF32_BN, rd.TF32_BR, rd.TF32_ROW_STEP,
        rd.TF32_STAGES, rd.TF32_SMEM, rd.TF32_WG_BM, rd.TF32_WG_BN,
        rd.TF32_WG_STAGES, rd.TF32_WG_SMEM, rd.TMA_THREADS, rd.MAX_GROUPS,
        rd.TF32_TN, rd.TF32_TJ, rd.TF32_SPLIT_T_THREADS)
    # 4 stages of a 128 x 32 weight tile and two 144 x 32 lhs planes; 3
    # of four 128 x 32 planes; 1024 bytes to align
    assert rd.TF32_SMEM == 4 * 53248 + 1024
    assert rd.TF32_WG_SMEM == 3 * 65536 + 1024
    assert rd.tf32_args(512, 14336, 8, 132) == (132, 384, rd.TF32_SMEM)
    assert rd.tf32_tiles(257, 136, 7) == (2 + 7) * 2
    assert rd.tf32_args(257, 136, 7, 132)[0] == 18
    assert rd.tf32_k_pad(4096) == 4096 and rd.tf32_k_pad(24) == 32
    assert rd.tf32_m_pad(2048, 8) == 32 * (64 + 8)
    assert rd.tf32_wgrad_split_args(2048, 4096, 14336, 8) == (
        72, 224, 2, 256, 0)
    # the padded rows on x: past 2.1M rows y would pass 65535
    assert rd.tf32_wgrad_split_args(2_200_000, 4096, 14336, 8)[:2] == (
        68758, 224)
    # the forward's lhs planes come from B1's split, padded to its BK
    assert rd.TF32_BK == pk.BK
    assert rd.tf32_wgrad_args(24, 136, 160, 132)[0] == 132
    assert rd.TF32_ENTRIES == {"ragged_dot_tf32": (4, 8),
                               "ragged_dot_wgrad_tf32_split": (5, 10),
                               "ragged_dot_wgrad_tf32": (4, 8)}


@pytest.mark.parametrize("g", [1, 7, 160, 1024])
def test_tf32_walk_stores_every_row_once(g):
    """The fp32 forward's walk over (group, 128-column tile, 144-row row
    tile): each row of each column tile stored by exactly one tile, the
    zero tail's included; each tile's rows, rounded up to 16, are one
    wgmma N of 16..144; no more tiles than the grid's bound."""
    m, sizes = _walk_sizes(g, g)
    n = 4 * 75                                   # 3 column tiles of 128
    ncol = -(-n // rd.TF32_BN)
    grid = 5
    stored = np.zeros((m, ncol), np.int64)
    tiles = list(rd.tf32_walk(sizes, m, n, grid))
    for block, grp, r0, rend, n0 in tiles:
        assert 0 <= grp <= g and n0 % rd.TF32_BN == 0 and n0 < n
        rows = min(rd.TF32_BR, rend - r0)
        assert rows >= 1
        if grp < g:
            step = -(-rows // rd.TF32_ROW_STEP) * rd.TF32_ROW_STEP
            assert 16 <= step <= rd.TF32_BR == 144
        stored[r0:r0 + rows, n0 // rd.TF32_BN] += 1
    assert (stored == 1).all()
    assert grid < len(tiles) <= rd.tf32_tiles(m, n, g)
    blocks = [t[0] for t in tiles]
    assert blocks == sorted(blocks)
    tail = [t for t in tiles if t[1] == g]
    assert min(t[2] for t in tail) == int(sizes.sum())


@pytest.mark.parametrize("g", [1, 7, 160, 1024])
def test_tf32_wgrad_walk_and_padded_layout(g):
    """The fp32 weight gradient's walk: every (group, K tile, N tile)
    exactly once; each group's stages start on a 32-column boundary of
    the transposed planes, hold its rows and nothing else, and end
    within Mpad = 32 (cdiv(M, 32) + G) whatever the sizes; the plain
    transposing split lays the rows out there."""
    m, sizes = _walk_sizes(g, g + 3)
    k, n = 4 * 45, 4 * 70                        # 2 K tiles, 3 N tiles
    seen = {}
    for block, grp, k0, n0, col, stages in rd.tf32_wgrad_walk(sizes, m, k,
                                                              n, 3):
        key = (grp, k0, n0)
        assert key not in seen and k0 < k and n0 < n
        seen[key] = (col, stages)
    nk, nn = -(-k // rd.TF32_WG_BM), -(-n // rd.TF32_WG_BN)
    assert len(seen) == g * nk * nn == rd.tf32_wgrad_tiles(k, n, g)
    mp = rd.tf32_m_pad(m, g)
    ends = np.cumsum(np.clip(sizes, 0, None))
    at = 0
    for grp in range(g):
        col, stages = seen[(grp, 0, 0)]
        rows = int(min(ends[grp], m) - min(ends[grp] - sizes[grp], m))
        assert col == at and col % 32 == 0
        assert stages == -(-rows // 32)
        at = col + 32 * stages
    assert at <= mp
    # the plain split of a few rows: group g's rows at its columns
    if g <= 7:
        x = torch.arange(m * 4, dtype=torch.float32).view(m, 4)
        planes = ref.ragged_dot_wgrad_tf32_split_ref(
            x, torch.from_numpy(sizes.astype(np.int32)), mp)
        for grp in range(g):
            col, stages = seen[(grp, 0, 0)]
            r0 = int(ends[grp] - sizes[grp])
            size = int(sizes[grp])
            assert torch.equal(planes[0, :, col:col + size],
                               ref.tf32_round(x[r0:r0 + size]).T)
            assert not planes[:, :, col + size:col + 32 * stages].any()


def _tf32x3_stages(a_planes, b_planes):
    """a (2, P, D), b (2, Q, D) hi/lo planes, D a multiple of 32 -> (P, Q):
    each 32-deep stage's lo hi + hi lo + hi hi in fp32, the stages' sums
    then added in fp32, as the route's fresh and running accumulators
    take them."""
    (ah, al), (bh, bl) = (x.reshape(x.shape[0], x.shape[1], -1, 32)
                          for x in (a_planes, b_planes))
    stage = (torch.einsum("psk,qsk->spq", al, bh)
             + torch.einsum("psk,qsk->spq", ah, bl)
             + torch.einsum("psk,qsk->spq", ah, bh))
    return stage.sum(0)


def _tf32x3_forward(lhs, rhs, sizes, transpose_rhs):
    """The fp32 route's forward emulated: lhs through B1's plain split,
    each group's weights split as the kernel splits them in registers."""
    m, k = lhs.shape
    w = rhs.transpose(1, 2) if transpose_rhs else rhs       # (G, K, N)
    kp = rd.tf32_k_pad(k)
    planes = ref.pairwise_kl_split_ref(lhs.unsqueeze(-1), False, kp)[0]
    out = torch.zeros((m, w.shape[2]), dtype=torch.float32)
    start = 0
    for g, size in enumerate(sizes.tolist()):
        size = max(0, min(size, m - start))
        if size:
            wt = torch.zeros((w.shape[2], kp))
            wt[:, :k] = w[g].T
            hi = ref.tf32_round(wt)
            w_planes = torch.stack([hi, ref.tf32_round(wt - hi)])
            out[start:start + size] = _tf32x3_stages(
                w_planes, planes[:, start:start + size]).T
        start += size
    return out


def _tf32x3_wgrad(lhs, grad, sizes):
    """The fp32 route's weight gradient emulated on the plain transposing
    split's planes: each group's stages only."""
    m = lhs.shape[0]
    g = sizes.shape[0]
    mp = rd.tf32_m_pad(m, g)
    lt = ref.ragged_dot_wgrad_tf32_split_ref(lhs, sizes, mp)
    gt = ref.ragged_dot_wgrad_tf32_split_ref(grad, sizes, mp)
    _, tile = rd.tf32_wgrad_tables(sizes.tolist(), m)
    out = torch.zeros((g, lhs.shape[1], grad.shape[1]))
    for grp in range(g):
        cols = slice(32 * tile[grp], 32 * tile[grp + 1])
        out[grp] = _tf32x3_stages(lt[:, :, cols], gt[:, :, cols])
    return out


@pytest.fixture
def one_thread():
    """Thousands of tiny products: torch's intra-op threads would spin
    beside the suite's other workers, so one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("depth", [4096, 14336])
def test_tf32x3_emulation_matches_jax(depth, one_thread):
    """The route's arithmetic (hi/lo TF32 splits, three products a 32-deep
    stage, fp32 sums of the stages) on the forward, the input gradient
    and the weight gradient, held against ``jax.lax.ragged_dot`` and its
    VJP within 1e-5 x max |out|: the forward at depth K = ``depth``, the
    input gradient at depth N = ``depth`` (mixtral-8x7b's depths), few
    rows and narrow outputs; the weight gradient of both, over the groups'
    rows."""
    rng = np.random.default_rng(depth)
    sizes = np.array([5, 0, 9, 6], np.int32)     # 4 rows past the sum
    m, w = 24, 8
    ts = torch.from_numpy(sizes)
    for k, n in ((depth, w), (w, depth)):
        lhs = rng.normal(size=(m, k)).astype(np.float32)
        rhs = (rng.normal(size=(4, k, n)) / np.sqrt(k)).astype(np.float32)
        dout = rng.normal(size=(m, n)).astype(np.float32)
        out, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, sizes),
                           jnp.asarray(lhs), jnp.asarray(rhs))
        d_lhs, d_rhs = vjp(jnp.asarray(dout))
        tl, tr, td = (torch.from_numpy(x) for x in (lhs, rhs, dout))
        wgrad = _tf32x3_wgrad(tl, td, ts)
        for got, want in ((_tf32x3_forward(tl, tr, ts, False), out),
                          (_tf32x3_forward(td, tr, ts, True), d_lhs),
                          (wgrad, d_rhs)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        assert not wgrad[1].any()                # the empty group
