"""The port's server kernels against the reference's Pallas kernels.

On the CPU the port's entry points run their plain PyTorch versions; they
are held against the JAX Pallas kernels run in interpret mode with small
blocks (as tests/test_kernels.py runs them), on the same numpy-seeded
inputs. The ``gpu``-marked tests hold each CUDA kernel against its plain
version on an sm_90 card and skip without one.

Tolerances: fp32 inputs 1e-5 (pairwise_kl, neighbor_mean) and 1e-4
(soft_ce, whose sums reach ~R*log C) — both sides reduce in fp32 in
different orders. bf16 inputs reuse the reference suite's bounds (5e-2,
0.3, 2e-2): the Pallas kernels round intermediates (exp(l) in
pairwise_kl) to bf16 where the port keeps fp32. The int8 strips
(dequant_kl) agree to 1e-5: the plain version decodes with the zero point
and ``torch.log_softmax``, the Pallas kernel with ``q·scale − lse`` and
JAX's ``logsumexp``, which round differently in the last fp32 bits of
log-probs of magnitude <= ~20.

Eq. 5 runs on the card as a gather over each graph's neighbor lists
(``neighbor_gather``); its plain version sums the slots in order, the
Pallas kernel over the dense W's columns: 1e-6 on probabilities <= 1.
Eq. 2 runs on the card as 3xTF32 (TF32 hi and lo parts, three products);
the split's numerics are checked here on an emulation in torch against
fp64, since the kernel itself only runs on the card.
"""
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.core import wire
from repro_torch.kernels import build
from repro_torch.core import (init_server, policy_round, sqmd,
                              upload_messengers)
from repro_torch.core.policies import as_policy
from repro_torch.kernels import dequant_kl as dk_mod
from repro_torch.kernels import neighbor_gather as ng_mod
from repro_torch.kernels import neighbor_mean as nm_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pairwise_kl as pk_mod
from repro_torch.kernels import soft_ce as sc_mod

# the reference kernel suite's shapes (tests/test_kernels.py::SHAPES)
SHAPES = [(4, 8, 3), (7, 13, 5), (20, 100, 10), (32, 64, 2), (9, 50, 26)]
DTYPES = ["float32", "bfloat16"]
TOL = {"pairwise_kl": {"float32": 1e-5, "bfloat16": 5e-2},
       "soft_ce": {"float32": 1e-4, "bfloat16": 0.3},
       "neighbor_mean": {"float32": 1e-5, "bfloat16": 2e-2}}


@pytest.fixture(scope="module")
def pallas():
    """The reference's Pallas kernels (imported here, not at the top, so
    the ``gpu`` tests also run where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import dequant_kl, neighbor_mean, pairwise_kl, soft_ce
    return types.SimpleNamespace(
        jnp=jnp, pairwise_kl=pairwise_kl.pairwise_kl,
        pairwise_kl_pair=pairwise_kl.pairwise_kl_pair,
        soft_ce=soft_ce.soft_ce, neighbor_mean=neighbor_mean.neighbor_mean,
        dequant_kl=dequant_kl)


def _log_softmax_np(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _as_dtype(jnp, x: np.ndarray, dtype: str):
    """The same values in both frameworks: bf16 inputs are rounded once in
    JAX and carried over exactly (every bf16 is an fp32)."""
    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _messengers(n, r, c, seed):
    rng = np.random.default_rng(seed)
    return _log_softmax_np(rng.normal(size=(n, r, c)) * 2.0)


def _int8_wire(logp: np.ndarray):
    """The port's int8 payload fields (q uint8, scale/zp bf16) of logp."""
    p = wire.encode("int8", torch.from_numpy(logp))
    return p.arrays["q"], p.arrays["scale"], p.arrays["zp"]


def _to_jax(jnp, q, s, z):
    """The same wire arrays in JAX (bf16 carried over exactly via fp32)."""
    return (jnp.asarray(q.numpy()),
            jnp.asarray(s.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(z.float().numpy()).astype(jnp.bfloat16))


INT8_SHAPES = [(4, 8, 3), (7, 13, 5), (12, 40, 10), (37, 13, 5)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pairwise_kl_matches_pallas(pallas, shape, dtype):
    n, r, c = shape
    j, t = _as_dtype(pallas.jnp, _messengers(n, r, c, 0), dtype)
    want = np.asarray(pallas.pairwise_kl(j, bn=8, bm=8, bk=32,
                                         interpret=True))
    got = ops.pairwise_kl(t)
    assert got.dtype == torch.float32 and got.shape == (n, n)
    tol = TOL["pairwise_kl"][dtype]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pairwise_kl_pair_matches_pallas(pallas, shape, dtype):
    n, r, c = shape
    u = max(1, n // 2 + 1)
    ja, ta = _as_dtype(pallas.jnp, _messengers(u, r, c, 1), dtype)
    jb, tb = _as_dtype(pallas.jnp, _messengers(n, r, c, 2), dtype)
    want = np.asarray(pallas.pairwise_kl_pair(ja, jb, bn=8, bm=8, bk=32,
                                              interpret=True))
    got = ops.pairwise_kl_pair(ta, tb)
    assert got.shape == (u, n)
    tol = TOL["pairwise_kl"][dtype]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def test_pairwise_kl_row_strips_match_one_call(monkeypatch):
    """CHUNK_ROWS streaming: row strips concatenate to the whole matrix."""
    assert ops.CHUNK_ROWS == 2048
    t = torch.from_numpy(_messengers(11, 9, 4, 3))
    whole = ops.pairwise_kl(t)
    monkeypatch.setattr(ops, "CHUNK_ROWS", 4)
    np.testing.assert_array_equal(ops.pairwise_kl(t).numpy(),
                                  whole.numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_soft_ce_matches_pallas_with_padded_labels(pallas, shape, dtype):
    n, r, c = shape
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(n, r, c)) * 3).astype(np.float32)
    labels = rng.integers(0, c, r).astype(np.int32)
    labels[rng.random(r) < 0.25] = -1          # padded reference rows
    j, t = _as_dtype(pallas.jnp, logits, dtype)
    want = np.asarray(pallas.soft_ce(j, pallas.jnp.asarray(labels), bn=4,
                                     br=16, interpret=True))
    got = ops.soft_ce(t, torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == (n,)
    tol = TOL["soft_ce"][dtype]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_neighbor_mean_matches_pallas(pallas, shape, dtype):
    n, r, c = shape
    rng = np.random.default_rng(5)
    probs = np.exp(_messengers(n, r, c, 6))
    w = rng.random((n, n)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    j, t = _as_dtype(pallas.jnp, probs, dtype)
    want = np.asarray(pallas.neighbor_mean(pallas.jnp.asarray(w), j, bn=8,
                                           bj=8, bk=32, interpret=True))
    got = ops.neighbor_mean(torch.from_numpy(w), t)
    assert got.dtype == torch.float32 and got.shape == (n, r, c)
    tol = TOL["neighbor_mean"][dtype]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_pairwise_kl_pair_matches_pallas(pallas, shape):
    """B4's plain version against the Pallas kernel in interpret mode
    with small (ragged) blocks, on the same int8 wire arrays."""
    n, r, c = shape
    u = max(1, n // 2 + 1)
    a = _int8_wire(_messengers(u, r, c, 11))
    b = _int8_wire(_messengers(n, r, c, 12))
    want = np.asarray(pallas.dequant_kl.int8_pairwise_kl_pair(
        *_to_jax(pallas.jnp, *a), *_to_jax(pallas.jnp, *b), bn=4, bm=8,
        br=8, interpret=True))
    got = ops.int8_pairwise_kl_pair(*a, *b)
    assert got.dtype == torch.float32 and got.shape == (u, n)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", INT8_SHAPES[:3])
def test_int8_pairwise_kl_square_matches_pallas(pallas, shape, monkeypatch):
    n, r, c = shape
    w = _int8_wire(_messengers(n, r, c, 13))
    want = np.asarray(pallas.dequant_kl.int8_pairwise_kl(
        *_to_jax(pallas.jnp, *w), bn=4, bm=8, br=8, interpret=True))
    np.testing.assert_allclose(ops.int8_pairwise_kl(*w).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    # CHUNK_ROWS streaming: row strips concatenate to the whole matrix
    # (the CPU product's blocking differs by shape: fp32 rounding only)
    whole = ops.int8_pairwise_kl(*w)
    monkeypatch.setattr(ops, "CHUNK_ROWS", 3)
    np.testing.assert_allclose(ops.int8_pairwise_kl(*w).numpy(),
                               whole.numpy(), atol=1e-6, rtol=1e-6)


def test_int8_row_stats_match_reference(pallas, monkeypatch):
    """lse = logsumexp_c(q·scale), chunked (here into 3-row chunks)."""
    q, s, _ = _int8_wire(_messengers(10, 6, 4, 14))
    want = np.asarray(pallas.dequant_kl.int8_row_stats(
        pallas.jnp.asarray(q.numpy()),
        pallas.jnp.asarray(s.float().numpy())))
    monkeypatch.setattr(dk_mod, "STATS_ELEMS", 3 * 6 * 4)
    got = dk_mod.int8_row_stats(q, s)
    assert got.dtype == torch.float32 and got.shape == (10, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# Eq. 5 over the neighbor lists (neighbor_gather)
# --------------------------------------------------------------------------

def _random_slots(n, k, rng):
    """(N,K) neighbor lists without self-edges, ~1/4 of the slots
    unrealized (weight 0, index arbitrary), and the dense W they scatter
    to (index_put with accumulate, as select_neighbors does)."""
    nbrs = np.stack([rng.choice(np.delete(np.arange(n), i), size=k,
                                replace=k > n - 1) for i in range(n)])
    valid = rng.random((n, k)) < 0.75
    w = np.where(valid, rng.random((n, k)), 0.0).astype(np.float32)
    w /= np.maximum(w.sum(1, keepdims=True), 1e-6)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (np.repeat(np.arange(n), k), nbrs.reshape(-1)),
              w.reshape(-1))
    return nbrs.astype(np.int32), w, dense


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_neighbor_gather_matches_pallas(pallas, shape, dtype):
    """The gather's plain version on (N,K) slots against the Pallas
    neighbor_mean on the dense W with those nonzeros."""
    n, r, c = shape
    rng = np.random.default_rng(16)
    nbrs, w, dense = _random_slots(n, min(3, n - 1), rng)
    j, t = _as_dtype(pallas.jnp, np.exp(_messengers(n, r, c, 17)), dtype)
    want = np.asarray(pallas.neighbor_mean(pallas.jnp.asarray(dense), j,
                                           bn=8, bj=8, bk=32,
                                           interpret=True))
    got = ops.neighbor_gather(torch.from_numpy(nbrs), torch.from_numpy(w), t)
    assert got.dtype == torch.float32 and got.shape == (n, r, c)
    tol = TOL["neighbor_mean"][dtype]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def _policy_graph(selection: str):
    """The graph and repository of a CPU SQMD round on numpy-seeded
    messengers: a full rebuild (exact) or a first IVF delta fire."""
    n, r, c = 40, 6, 5
    rng = np.random.default_rng(18)
    logp = _messengers(n, r, c, 19)
    labels = torch.from_numpy(rng.integers(0, c, r).astype(np.int32))
    state = upload_messengers(init_server(n, r, c, device="cpu"),
                              torch.from_numpy(logp),
                              torch.ones(n, dtype=torch.bool))
    pol = as_policy(sqmd(q=12, k=4))
    pol.selection = selection
    uploaded = np.ones(n, bool) if selection == "ivf" else None
    _, targets, graph = policy_round(state, pol, labels, uploaded=uploaded)
    return graph, logp, targets


@pytest.mark.parametrize("selection", ["exact", "ivf"])
def test_neighbor_gather_on_graph_slots_matches_pallas(pallas, selection):
    """Eq. 5 over a real graph's slots equals the reference's Pallas
    neighbor_mean (interpret mode) on the graph's dense W, within 1e-6;
    so do the targets the policy emitted."""
    graph, logp, targets = _policy_graph(selection)
    probs = np.exp(logp)
    want = np.asarray(pallas.neighbor_mean(
        pallas.jnp.asarray(graph.weights.numpy()), pallas.jnp.asarray(probs),
        bn=8, bj=8, bk=32, interpret=True))
    got = ref.neighbor_gather_ref(graph.neighbors, graph.slot_weights,
                                  torch.from_numpy(probs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(targets.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("selection", ["exact", "ivf"])
def test_slot_weights_scatter_to_the_dense_weights(selection):
    graph, _, _ = _policy_graph(selection)
    n, k = graph.neighbors.shape
    assert graph.slot_weights.shape == (n, k)
    assert graph.slot_weights.dtype == torch.float32
    w = torch.zeros((n, n))
    w.index_put_((torch.arange(n).repeat_interleave(k),
                  graph.neighbors.reshape(-1).long()),
                 graph.slot_weights.reshape(-1), accumulate=True)
    np.testing.assert_array_equal(w.numpy(), graph.weights.numpy())
    assert int((graph.slot_weights > 0).sum()) > 0


def test_neighbor_gather_sums_slots_in_order():
    """The plain version adds slot j after slots 0..j-1: a slot of weight
    0 adds exactly nothing, and an empty list gives zeros."""
    probs = torch.from_numpy(np.exp(_messengers(6, 4, 3, 20)))
    nbrs = torch.tensor([[1, 2], [0, 0], [5, 4], [0, 1], [2, 3], [4, 0]],
                        dtype=torch.int32)
    w = torch.tensor([[0.5, 0.5], [1.0, 0.0], [0.25, 0.75], [0.0, 0.0],
                      [1.0, 0.0], [0.5, 0.5]])
    got = ref.neighbor_gather_ref(nbrs, w, probs)
    flat = probs.reshape(6, -1)
    for i in range(6):
        want = torch.zeros_like(flat[0])
        for j in range(2):
            want = want + w[i, j] * flat[nbrs[i, j]]
        assert torch.equal(got.reshape(6, -1)[i], want)
    empty = ref.neighbor_gather_ref(torch.zeros((6, 0), dtype=torch.int32),
                                    torch.zeros((6, 0)), probs)
    assert torch.equal(empty, torch.zeros_like(probs))


# --------------------------------------------------------------------------
# Eq. 2 as 3xTF32: the split's numerics, emulated on the CPU
# --------------------------------------------------------------------------

def test_tf32_round_is_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                          # TF32's spacing in [1, 2)
    x = torch.tensor([one, one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4,
                      -(one + ulp / 2), 3.0e-3, -7.25e2], dtype=torch.float32)
    got = ref.tf32_round(x)
    assert got[0] == 1.0
    assert got[1] == one + ulp                # a tie goes away from zero
    assert got[2] == 1.0                      # below half: down
    assert got[3] == one + ulp                # above half: up
    assert got[4] == -(one + ulp)
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())  # 13 low bits cleared
    rng = np.random.default_rng(21)
    y = torch.from_numpy((rng.normal(size=4096) * 10).astype(np.float32))
    h = ref.tf32_round(y)
    # within half a TF32 ulp of the input (2^-11 relative)
    assert bool(((h - y).abs() <= y.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("a_side", [True, False])
def test_split_planes_rebuild_the_operand(a_side):
    """hi + lo equals x (= exp(l) or l) to ~2^-22 relative, the padding is
    zero, and the A side's row term is sum_k p l."""
    r, c = 13, 5
    logp = torch.from_numpy(_messengers(9, r, c, 22))
    k_pad = -(-r * c // pk_mod.BK) * pk_mod.BK
    planes, rowterm = ref.pairwise_kl_split_ref(logp, a_side, k_pad)
    assert planes.shape == (2, 9, k_pad) and k_pad == 96
    lf = logp.reshape(9, -1).double()
    x = lf.exp() if a_side else lf
    back = planes[0, :, :r * c].double() + planes[1, :, :r * c].double()
    assert float(((back - x).abs() / x.abs()).max()) <= 2.0 ** -21
    assert bool((planes[:, :, r * c:] == 0).all())
    if a_side:
        np.testing.assert_allclose(rowterm.double().numpy(),
                                   (x * lf).sum(1).numpy(), rtol=1e-6)
    else:
        assert rowterm is None


def test_3xtf32_cross_term_error_within_twice_fp32():
    """At the server's value ranges (R=240, C=10, log_softmax(2 N(0,1))),
    the 3xTF32 cross term hi hi + hi lo + lo hi, and the strip built on
    it, are as close to fp64 as the fp32 products are, within 2x."""
    r, c = 240, 10
    la = torch.from_numpy(_messengers(48, r, c, 23))
    lb = torch.from_numpy(_messengers(96, r, c, 24))
    k = r * c
    k_pad = -(-k // pk_mod.BK) * pk_mod.BK
    a_planes, rowterm = ref.pairwise_kl_split_ref(la, True, k_pad)
    b_planes, _ = ref.pairwise_kl_split_ref(lb, False, k_pad)
    pa64 = la.reshape(48, k).double().exp()
    lb64 = lb.reshape(96, k).double()
    exact = pa64 @ lb64.T
    (ah, al), (bh, bl) = a_planes, b_planes
    cross3 = (ah @ bh.T + ah @ bl.T + al @ bh.T).double()
    cross32 = (la.reshape(48, k).exp() @ lb.reshape(96, k).T).double()
    err3 = float((cross3 - exact).abs().max())
    err32 = float((cross32 - exact).abs().max())
    assert err3 <= 2 * err32, (err3, err32)
    # plain TF32 alone would be ~1000x worse: the split is what saves it
    err1 = float(((ah @ bh.T).double() - exact).abs().max())
    assert err1 > 50 * err32
    truth = ((pa64 * la.reshape(48, k).double()).sum(1)[:, None] - exact) / r
    strip3 = ref.pairwise_kl_gemm_ref(a_planes, rowterm, b_planes, r)
    strip32 = ref.pairwise_kl_pair_ref(la, lb)
    e3 = float((strip3.double() - truth).abs().max())
    e32 = float((strip32.double() - truth).abs().max())
    assert e3 <= 2 * e32, (e3, e32)
    np.testing.assert_allclose(strip3.numpy(), strip32.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_cpu_calls_count_no_launches():
    ops.reset_launch_counts()
    t = torch.from_numpy(_messengers(5, 6, 3, 7))
    ops.pairwise_kl(t)
    ops.pairwise_kl_pair(t[:2], t)
    ops.soft_ce(t, torch.zeros(6, dtype=torch.int32))
    ops.neighbor_mean(torch.eye(5), torch.exp(t))
    ops.neighbor_gather(torch.zeros((5, 2), dtype=torch.int32),
                        torch.ones((5, 2)), torch.exp(t))
    q, s, z = _int8_wire(_messengers(5, 6, 3, 7))
    ops.int8_pairwise_kl(q, s, z)
    assert ops.launch_counts() == {"pairwise_kl_split": 0,
                                   "pairwise_kl_pair": 0, "soft_ce": 0,
                                   "neighbor_gather": 0, "neighbor_mean": 0,
                                   "int8_pairwise_kl_pair": 0}


@pytest.mark.parametrize("call", ["pairwise_kl", "soft_ce", "neighbor_mean",
                                  "int8_pairwise_kl", "neighbor_gather",
                                  "pairwise_kl_split"])
def test_non_cpu_tensor_never_takes_the_plain_version(call):
    """Only a CPU tensor reaches the plain version: any other device goes
    to the kernel path, whose checks refuse what is not a CUDA tensor."""
    z = torch.empty((4, 6, 3), device="meta")
    q = torch.empty((4, 6, 3), dtype=torch.uint8, device="meta")
    s = torch.empty((4, 6), device="meta")
    args = {"pairwise_kl": (pk_mod.pairwise_kl_pair, (z, z)),
            "soft_ce": (sc_mod.soft_ce,
                        (z, torch.empty(6, dtype=torch.int32,
                                        device="meta"))),
            "neighbor_mean": (nm_mod.neighbor_mean,
                              (torch.empty((4, 4), device="meta"), z)),
            "int8_pairwise_kl": (dk_mod.int8_pairwise_kl_pair,
                                 (q, s, s, q, s, s)),
            "neighbor_gather": (ng_mod.neighbor_gather,
                                (torch.empty((4, 2), dtype=torch.int32,
                                             device="meta"),
                                 torch.empty((4, 2), device="meta"), z)),
            "pairwise_kl_split": (pk_mod.split, (z, True))}
    fn, a = args[call]
    with pytest.raises(ValueError, match="CUDA"):
        fn(*a)


def test_shape_checks_raise():
    with pytest.raises(ValueError):
        pk_mod.pairwise_kl_pair(torch.zeros(2, 3, 4), torch.zeros(2, 3, 5))
    with pytest.raises(ValueError):
        sc_mod.soft_ce(torch.zeros(2, 3, 4), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        nm_mod.neighbor_mean(torch.zeros(3, 3), torch.zeros(2, 3, 4))
    q, s = torch.zeros(2, 3, 4, dtype=torch.uint8), torch.zeros(2, 3)
    with pytest.raises(ValueError):
        dk_mod.int8_pairwise_kl_pair(q, s, s, q[:, :, :3], s, s)
    with pytest.raises(ValueError):
        dk_mod.int8_pairwise_kl_pair(q, s[:, :2], s, q, s, s)
    nb = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        ng_mod.neighbor_gather(nb, torch.zeros(2, 4), torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        ng_mod.neighbor_gather(nb, torch.zeros(2, 3), torch.zeros(3, 3, 4))


@pytest.mark.parametrize("mod", [pk_mod, sc_mod, nm_mod, dk_mod, ng_mod],
                         ids=lambda m: m.ENTRY)
def test_wrapper_matches_its_c_entry_point(mod):
    """Each wrapper loads a source the build compiles and declares, for
    every C entry point it calls, the argument list that entry has:
    device pointers, ints, then the stream (ctypes would otherwise
    truncate or misplace arguments)."""
    assert mod.SOURCE in build.SOURCES
    assert mod.ENTRY in mod.ENTRIES
    src = (build.CSRC / f"{mod.SOURCE}.cu").read_text()
    for entry, (n_ptr, n_int) in mod.ENTRIES.items():
        sig = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
        assert sig is not None, entry
        params = [p.strip() for p in sig.group(1).split(",")]
        assert params[-1] == "void* stream"
        assert all("void*" in p for p in params[:n_ptr])
        assert all(p.startswith("int ") for p in params[n_ptr:-1])
        assert len(params) == n_ptr + n_int + 1


def test_package_imports_neither_jax_nor_the_reference():
    """Every module of repro_torch imports in a fresh interpreter with no
    jax and no repro.* module loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "print(len(list(pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'))))\n"
        "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20       # every module was walked


# --------------------------------------------------------------------------
# on the card (sm_90): each CUDA kernel against its plain version
# --------------------------------------------------------------------------

@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 card (kernels build for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


GPU_SHAPES = [(4, 8, 3), (37, 13, 5), (130, 240, 10), (32, 240, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernels_match_plain(hopper, shape, dtype):
    n, r, c = shape
    rng = np.random.default_rng(8)
    dt = getattr(torch, dtype)
    logp = torch.from_numpy(_messengers(n, r, c, 9)).to(hopper, dt)
    half = logp[: n // 2 + 1].contiguous()
    labels = torch.from_numpy(
        rng.integers(-1, c, r).astype(np.int32)).to(hopper)
    w = torch.from_numpy(rng.random((n, n)).astype(np.float32)).to(hopper)
    w /= w.sum(1, keepdim=True)
    nbrs, sw, _ = _random_slots(n, min(8, n - 1), rng)
    nbrs, sw = (torch.from_numpy(x).to(hopper) for x in (nbrs, sw))
    probs = torch.exp(logp.float()).to(dt)
    ops.reset_launch_counts()
    for got, want, tol in [
            (ops.pairwise_kl(logp), ref.pairwise_kl_ref(logp), 1e-5),
            (ops.pairwise_kl_pair(half, logp),
             ref.pairwise_kl_pair_ref(half, logp), 1e-5),
            (ops.soft_ce(logp, labels), ref.soft_ce_ref(logp, labels), 1e-4),
            (ops.neighbor_mean(w, probs), ref.neighbor_mean_ref(w, probs),
             1e-5),
            (ops.neighbor_gather(nbrs, sw, probs),
             ref.neighbor_gather_ref(nbrs, sw, probs), 1e-6)]:
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=tol, rtol=tol)
    # each Eq. 2 call splits both operands (2 launches) then runs one GEMM
    assert ops.launch_counts() == {"pairwise_kl_split": 4,
                                   "pairwise_kl_pair": 2, "soft_ce": 1,
                                   "neighbor_gather": 1, "neighbor_mean": 1,
                                   "int8_pairwise_kl_pair": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("a_side", [True, False])
def test_cuda_split_matches_plain(hopper, a_side):
    """The split pass against its plain version: the planes bit for bit
    on the B side (no exp); on the A side, where the two exp may differ in
    the last bit, hi + lo within 1e-6 relative and the row term within
    1e-5. Every plane value is a TF32 (13 low bits zero)."""
    logp = torch.from_numpy(_messengers(70, 37, 13, 25)).to(hopper)
    got = pk_mod.split(logp, a_side)
    planes, rowterm = ref.pairwise_kl_split_ref(logp, a_side,
                                                got.planes.shape[2])
    torch.cuda.synchronize()
    assert bool(((got.planes.view(torch.int32) & 0x1FFF) == 0).all())
    if a_side:
        np.testing.assert_allclose(got.planes.sum(0).cpu().numpy(),
                                   planes.sum(0).cpu().numpy(), rtol=1e-6)
        np.testing.assert_allclose(got.rowterm.cpu().numpy(),
                                   rowterm.cpu().numpy(), rtol=1e-5)
    else:
        assert torch.equal(got.planes, planes) and got.rowterm is None


@pytest.mark.gpu
@pytest.mark.parametrize("u,m", [(1, 300), (300, 1), (64, 1000),
                                 (1000, 64), (129, 257)])
@pytest.mark.parametrize("rc", [(8, 10), (240, 10)])
def test_cuda_pairwise_kl_thin_strips(hopper, u, m, rc):
    """The strips the delta rounds and the IVF index run: one row or
    column, 64-row uploads, and edges one past a 128-row tile."""
    la = torch.from_numpy(_messengers(u, *rc, 28)).to(hopper)
    lb = torch.from_numpy(_messengers(m, *rc, 29)).to(hopper)
    got = ops.pairwise_kl_pair(la, lb)
    want = ref.pairwise_kl_pair_ref(la, lb)
    torch.cuda.synchronize()
    assert got.shape == (u, m)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_cuda_tied_divergences_break_as_on_the_cpu(hopper):
    """Round 0's case: identical messengers make every divergence of a
    row tie, so the graph is decided by tie-breaks alone. The card's
    3xTF32 strips and gather pick the CPU's neighbors (lowest indices)
    and emit its targets."""
    n, r, c = 40, 24, 5
    rng = np.random.default_rng(30)
    one = _log_softmax_np(rng.normal(size=(1, r, c)) * 2.0)
    logp = torch.from_numpy(np.repeat(one, n, axis=0))
    labels = torch.from_numpy(rng.integers(0, c, r).astype(np.int32))
    out = {}
    for dev in ("cpu", hopper):
        state = upload_messengers(init_server(n, r, c, device=dev),
                                  logp.to(dev),
                                  torch.ones(n, dtype=torch.bool))
        _, targets, graph = policy_round(state, as_policy(sqmd(q=12, k=4)),
                                         labels.to(dev))
        out[str(dev)] = (graph, targets.cpu())
    (gc, tc), (gg, tg) = out["cpu"], out[str(hopper)]
    assert torch.equal(gc.candidates, gg.candidates.cpu())
    assert torch.equal(gc.neighbors, gg.neighbors.cpu())
    assert torch.equal(gc.slot_weights, gg.slot_weights.cpu())
    np.testing.assert_allclose(tg.numpy(), tc.numpy(), atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_cuda_3xtf32_error_within_twice_fp32(hopper):
    """On a server-sized strip (R=240, C=10), the kernel's error against
    fp64 is at most twice the fp32 plain version's (cuBLAS, no TF32)."""
    la = torch.from_numpy(_messengers(256, 240, 10, 26)).to(hopper)
    lb = torch.from_numpy(_messengers(512, 240, 10, 27)).to(hopper)
    got = ops.pairwise_kl_pair(la, lb).double()
    plain = ref.pairwise_kl_pair_ref(la, lb).double()
    a64, b64 = la.reshape(256, -1).double(), lb.reshape(512, -1).double()
    pa = a64.exp()
    truth = ((pa * a64).sum(1)[:, None] - pa @ b64.T) / 240
    e_kern = float((got - truth).abs().max())
    e_plain = float((plain - truth).abs().max())
    assert e_kern <= 2 * e_plain, (e_kern, e_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES + [(1, 8, 10), (300, 8, 10)])
def test_cuda_int8_kernel_matches_plain(hopper, shape):
    """B4 against its plain version on the card, bf16 wire scale, square
    and both strip orientations (1 x m and m x 1 included)."""
    n, r, c = shape
    q, s, z = (t.to(hopper) for t in _int8_wire(_messengers(n, r, c, 15)))
    one = (q[:1].contiguous(), s[:1].contiguous(), z[:1].contiguous())
    ops.reset_launch_counts()
    for got, want in [
            (ops.int8_pairwise_kl(q, s, z), ref.int8_pairwise_kl_ref(q, s, z)),
            (ops.int8_pairwise_kl_pair(*one, q, s, z),
             ref.int8_pairwise_kl_pair_ref(*one, q, s, z)),
            (ops.int8_pairwise_kl_pair(q, s, z, *one),
             ref.int8_pairwise_kl_pair_ref(q, s, z, *one))]:
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
    assert ops.launch_counts()["int8_pairwise_kl_pair"] == 3
