"""The grouped product's CUDA kernels (``kernels/csrc/ragged_dot.cu``) on
the card (``gpu``-marked: skips without an sm_90 card). This file
imports no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m gpu --noconftest \\
        tests/test_torch_gpu_ragged_dot.py

The forward, the forward on rhs transposed (the input gradient) and the
weight gradient against their plain versions in fp32 and bf16, at odd
shapes (no extent a tile's multiple, scalar loads) and aligned ones
(16-byte loads), with empty groups, one group holding every row, rows past
the groups' sum and 160 groups; the Hopper route (bf16, K and N multiples
of 8) on its own edges, its route counter read: groups straddling every
tile edge, K a multiple of 8 but not of 64, empty first and last groups,
rows past the sum, 160 groups, more tiles than one persistent pass; the
fp32 Hopper route (3xTF32, K and N multiples of 4) on the same edges and
its own (one group holding every row, K and N multiples of 4 but not of
8), its counters read; which route fp32 and odd widths take; the op's
autograd on the card against the CPU's; the dropless FFN's forward and
backward in bf16 and fp32 under ``torch.cuda.set_sync_debug_mode(
"error")``, with exactly three forward launches a layer and three plus
three in the backward.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ragged_dot as rd
from repro_torch.kernels.ref import ragged_dot_ref, ragged_dot_wgrad_ref

pytestmark = pytest.mark.gpu

# (M, K, N): odd (scalar loads, ragged tiles) and aligned (16-byte loads)
SHAPES = {"odd": (257, 21, 131), "aligned": (320, 64, 256)}
# bf16: one rounding of an fp32 sum, against the same sum in fp32 (its
# order differs): half an ulp plus fp32 noise, under one bf16 ulp
BF16_ULP = 2.0 ** -8


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 card")
    return torch.device("cuda")


def _sizes(kind: str, m: int, rng) -> np.ndarray:
    if kind == "one_group_all_rows":
        return np.array([0, m, 0], np.int32)
    if kind == "past_the_sum":        # empty groups, 40 rows past the sum
        return np.array([0, 50, 0, 0, m - 90, 0, 0], np.int32)
    cuts = np.sort(rng.integers(0, m + 1, 159))          # 160 groups
    return np.diff(np.concatenate([[0], cuts, [m]])).astype(np.int32)


def _close(got, want, dtype, scale):
    got, want = got.double(), want.double()
    if dtype == torch.float32:
        tol = 1e-5 * scale
        assert (got - want).abs().max() <= tol
    else:
        tol = BF16_ULP * want.abs() + BF16_ULP * 1e-2 * scale
        assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", ["one_group_all_rows", "past_the_sum",
                                  "160_groups"])
def test_kernels_match_plain(hopper, dtype, shape, kind):
    m, k, n = SHAPES[shape]
    rng = np.random.default_rng(0)
    sizes = _sizes(kind, m, rng)
    g = len(sizes)

    def draw(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32)) \
            .to(dtype).to(hopper)

    lhs, rhs, dout = draw(m, k), draw(g, k, n), draw(m, n)
    ts = torch.from_numpy(sizes).to(hopper)
    f32 = [t.float() for t in (lhs, rhs, dout)]
    before = ops.launch_counts()
    cases = [
        (rd.ragged_dot(lhs, rhs, ts, False),
         ragged_dot_ref(f32[0], f32[1], ts), np.sqrt(k)),
        (rd.ragged_dot(dout, rhs, ts, True),
         ragged_dot_ref(f32[2], f32[1], ts, True), np.sqrt(n)),
        (rd.ragged_dot_wgrad(lhs, dout, ts),
         ragged_dot_wgrad_ref(f32[0], f32[2], ts), np.sqrt(m))]
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["ragged_dot"] - before["ragged_dot"] == 2
    assert after["ragged_dot_wgrad"] - before["ragged_dot_wgrad"] == 1
    used = int(min(sizes.sum(), m))
    for got, want, scale in cases:
        assert got.dtype == dtype and got.shape == want.shape
        _close(got, want, dtype, float(scale))
    assert not cases[0][0][used:].any() and not cases[1][0][used:].any()
    for i in np.flatnonzero(sizes == 0):
        assert not cases[2][0][i].any()


# the Hopper route's cases: (M, K, N) and the group sizes
TMA_CASES = {
    # groups ending one row before, on and after every 64- and 128-row
    # edge, N past one 256-column tile
    "straddling_tile_edges": (1200, 128, 520,
                              [1, 63, 64, 65, 127, 128, 129, 255, 256, 112]),
    # K = 200 (three 64-deep stages and a part), N = 264
    "k_not_a_stage_multiple": (300, 200, 264, [70, 90, 140]),
    # empty first and last groups, 40 rows past the sum
    "empty_ends_rows_past_the_sum": (300, 64, 136, [0, 100, 0, 160, 0]),
    "160_groups": (1536, 136, 264, None),
    # (cdiv(4096, 128) + 8) x 8 column tiles: more than 132 blocks take
    "several_passes": (4096, 64, 2048, [512] * 8),
}


@pytest.mark.parametrize("case", sorted(TMA_CASES))
def test_hopper_route_matches_plain(hopper, case):
    m, k, n, sizes = TMA_CASES[case]
    rng = np.random.default_rng(2)
    if sizes is None:
        sizes = _sizes("160_groups", m, rng)
    sizes = np.asarray(sizes, np.int32)
    g = len(sizes)
    if case == "several_passes":
        assert rd.tma_tiles(m, n, g) > 132

    def draw(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32)) \
            .to(torch.bfloat16).to(hopper)

    lhs, rhs, dout = draw(m, k), draw(g, k, n), draw(m, n)
    ts = torch.from_numpy(sizes).to(hopper)
    f32 = [t.float() for t in (lhs, rhs, dout)]
    before = ops.route_counts()
    cases = [
        (rd.ragged_dot(lhs, rhs, ts, False),
         ragged_dot_ref(f32[0], f32[1], ts), np.sqrt(k)),
        (rd.ragged_dot(dout, rhs, ts, True),
         ragged_dot_ref(f32[2], f32[1], ts, True), np.sqrt(n)),
        (rd.ragged_dot_wgrad(lhs, dout, ts),
         ragged_dot_wgrad_ref(f32[0], f32[2], ts), np.sqrt(m))]
    torch.cuda.synchronize()
    after = ops.route_counts()
    assert after["ragged_dot.tma"] - before["ragged_dot.tma"] == 2
    assert after["ragged_dot_wgrad.tma"] \
        - before["ragged_dot_wgrad.tma"] == 1
    used = int(min(sizes.sum(), m))
    for got, want, scale in cases:
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _close(got, want, torch.bfloat16, float(scale))
    assert not cases[0][0][used:].any() and not cases[1][0][used:].any()
    for i in np.flatnonzero(sizes == 0):
        assert not cases[2][0][i].any()


# the fp32 Hopper route's own cases beside TMA_CASES: one group holding
# every row, K and N multiples of 4 but not of 8
TF32_CASES = {
    "one_group_all_rows": (257, 24, 136, [0, 257, 0]),
    "widths_of_4_not_8": (300, 20, 36, [100, 0, 150, 10]),
}


@pytest.mark.parametrize("case", sorted({**TMA_CASES, **TF32_CASES}))
def test_tf32_route_matches_plain(hopper, case):
    """The fp32 Hopper route at the bf16 route's edges and its own, each
    entry within 1e-5 of its plain version's scale, rows past the sum and
    empty groups' gradients 0, every call on that route."""
    m, k, n, sizes = {**TMA_CASES, **TF32_CASES}[case]
    rng = np.random.default_rng(3)
    if sizes is None:
        sizes = _sizes("160_groups", m, rng)
    sizes = np.asarray(sizes, np.int32)
    g = len(sizes)

    def draw(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32)) \
            .to(hopper)

    lhs, rhs, dout = draw(m, k), draw(g, k, n), draw(m, n)
    ts = torch.from_numpy(sizes).to(hopper)
    before = ops.route_counts()
    cases = [
        (rd.ragged_dot(lhs, rhs, ts, False), ragged_dot_ref(lhs, rhs, ts),
         np.sqrt(k)),
        (rd.ragged_dot(dout, rhs, ts, True),
         ragged_dot_ref(dout, rhs, ts, True), np.sqrt(n)),
        (rd.ragged_dot_wgrad(lhs, dout, ts),
         ragged_dot_wgrad_ref(lhs, dout, ts), np.sqrt(m))]
    torch.cuda.synchronize()
    moved = {name: c - before[name] for name, c in ops.route_counts().items()}
    assert moved == {"ragged_dot.tma": 0, "ragged_dot_wgrad.tma": 0,
                     "ragged_dot.tf32": 2, "ragged_dot.tf32_split": 2,
                     "ragged_dot_wgrad.tf32": 1,
                     "ragged_dot_wgrad.tf32_split": 1}
    used = int(min(sizes.sum(), m))
    for got, want, scale in cases:
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close(got, want, torch.float32, float(scale))
    assert not cases[0][0][used:].any() and not cases[1][0][used:].any()
    for i in np.flatnonzero(sizes == 0):
        assert not cases[2][0][i].any()


def test_tf32_route_takes_fp32_at_aligned_widths(hopper):
    """fp32 at widths that are multiples of 4 takes the fp32 Hopper route:
    its counters move (a split and a product a call), the bf16 route's do
    not, and each call counts once in its kernel's total."""
    sizes = torch.tensor([30, 0, 50], dtype=torch.int32, device=hopper)
    before, routes = ops.launch_counts(), ops.route_counts()
    for k, n in ((64, 136), (20, 12)):
        lhs = torch.randn(90, k, device=hopper)
        rhs = torch.randn(3, k, n, device=hopper)
        dout = torch.randn(90, n, device=hopper)
        rd.ragged_dot(lhs, rhs, sizes, False)
        rd.ragged_dot_wgrad(lhs, dout, sizes)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["ragged_dot"] - before["ragged_dot"] == 2
    assert after["ragged_dot_wgrad"] - before["ragged_dot_wgrad"] == 2
    moved = {name: c - routes[name] for name, c in ops.route_counts().items()}
    assert moved == {"ragged_dot.tma": 0, "ragged_dot_wgrad.tma": 0,
                     "ragged_dot.tf32": 2, "ragged_dot.tf32_split": 2,
                     "ragged_dot_wgrad.tf32": 2,
                     "ragged_dot_wgrad.tf32_split": 2}


def test_first_route_keeps_odd_widths(hopper):
    """bf16 and fp32 at odd widths take the first route: the totals move,
    no Hopper route's counters do."""
    sizes = torch.tensor([30, 0, 50], dtype=torch.int32, device=hopper)
    before, routes = ops.launch_counts(), ops.route_counts()
    for dtype, k, n in ((torch.bfloat16, 21, 136), (torch.bfloat16, 64, 131),
                        (torch.float32, 21, 136), (torch.float32, 64, 131),
                        (torch.float32, 6, 136)):
        lhs = torch.randn(90, k, device=hopper).to(dtype)
        rhs = torch.randn(3, k, n, device=hopper).to(dtype)
        dout = torch.randn(90, n, device=hopper).to(dtype)
        rd.ragged_dot(lhs, rhs, sizes, False)
        rd.ragged_dot_wgrad(lhs, dout, sizes)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["ragged_dot"] - before["ragged_dot"] == 5
    assert after["ragged_dot_wgrad"] - before["ragged_dot_wgrad"] == 5
    assert ops.route_counts() == routes


def test_autograd_on_the_card_matches_the_cpu(hopper):
    rng = np.random.default_rng(1)
    sizes = torch.tensor([40, 0, 77, 9], dtype=torch.int32)
    x = rng.normal(size=(130, 48)).astype(np.float32)
    w = rng.normal(size=(4, 48, 72)).astype(np.float32)
    dy = rng.normal(size=(130, 72)).astype(np.float32)
    grads = []
    for dev in ("cpu", hopper):
        tx = torch.from_numpy(x).to(dev).requires_grad_()
        tw = torch.from_numpy(w).to(dev).requires_grad_()
        y = ops.ragged_dot(tx, tw, sizes.to(dev))
        y.backward(torch.from_numpy(dy).to(dev))
        grads.append([t.detach().cpu() for t in (y, tx.grad, tw.grad)])
    for got, want in zip(grads[1], grads[0]):
        assert (got - want).abs().max() <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("dtype", ["param", "float32"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-236b"])
def test_dropless_ffn_is_sync_free_on_the_card(hopper, arch, dtype):
    """The reduced config's FFN in its own bf16 (the Hopper route) and in
    fp32 (the fp32 Hopper route)."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models.common import Init
    from repro_torch.models.ffn import init_moe, moe_dropless_forward
    cfg = get_reduced(arch)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    torch.manual_seed(0)
    p = init_moe(Init(None, hopper), cfg)
    for v in p.values():
        if isinstance(v, torch.Tensor):
            v.requires_grad_()
    x = torch.randn(2, 33, cfg.d_model, device=hopper,
                    dtype=cfg.param_dtype, requires_grad=True)
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe_dropless_forward(p, cfg, x)
        fwd = ops.launch_counts()
        (y.float().square().mean() + aux).backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = ops.launch_counts()
    assert fwd["ragged_dot"] == 3 and fwd["ragged_dot_wgrad"] == 0
    assert counts["ragged_dot"] == 6 and counts["ragged_dot_wgrad"] == 3
    assert all(v == 0 for name, v in counts.items()
               if not name.startswith("ragged_dot"))
    routes = ops.route_counts()
    hopper_route = "tf32" if dtype == "float32" else "tma"
    assert routes[f"ragged_dot.{hopper_route}"] == 6
    assert routes[f"ragged_dot_wgrad.{hopper_route}"] == 3
    assert torch.isfinite(x.grad).all() and p["w_gate"].grad.abs().sum() > 0
