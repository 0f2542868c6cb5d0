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
(dequant_kl) agree to 1e-5: both decode with ``q·scale − lse``, the plain
version's lse from ``torch.logsumexp``, the Pallas kernel's from JAX's,
which round differently in the last fp32 bits of log-probs of magnitude
<= ~20.

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


def _fedmd_w(n: int, seed: int) -> np.ndarray:
    """FedMD's complete graph over a random two-thirds of n clients: every
    row 1/n_active on the active columns (not exact in TF32), 0 else."""
    active = np.random.default_rng(seed).random(n) < 2 / 3
    active[0] = True
    return np.tile(active / np.float32(active.sum()),
                   (n, 1)).astype(np.float32)


@pytest.mark.parametrize("shape", [(7, 13, 5), (9, 50, 26), (37, 13, 5)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_neighbor_mean_on_a_dense_fedmd_w_matches_pallas(pallas, shape,
                                                         dtype):
    """The dense entry's plain version on FedMD's complete graph, against
    the Pallas kernel in interpret mode with blocks that divide neither N
    nor R*C."""
    n, r, c = shape
    w = _fedmd_w(n, 31)
    j, t = _as_dtype(pallas.jnp, np.exp(_messengers(n, r, c, 32)), dtype)
    want = np.asarray(pallas.neighbor_mean(pallas.jnp.asarray(w), j, bn=8,
                                           bj=8, bk=32, interpret=True))
    got = ops.neighbor_mean(torch.from_numpy(w), t)
    assert got.dtype == torch.float32 and got.shape == (n, r, c)
    tol = TOL["neighbor_mean"][dtype]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def test_transposing_split_planes_rebuild_s_transposed():
    """S^T's planes: hi + lo equals S^T to ~2^-22 relative, every value a
    TF32, zero past N (K padded to the GEMM's k-tile)."""
    n, r, c = 37, 13, 5
    probs = torch.exp(torch.from_numpy(_messengers(n, r, c, 33)))
    k_pad = -(-n // pk_mod.BK) * pk_mod.BK
    planes = ref.neighbor_mean_split_ref(probs, k_pad)
    assert planes.shape == (2, r * c, k_pad) and k_pad == 64
    st = probs.reshape(n, -1).T.double()
    back = planes[0, :, :n].double() + planes[1, :, :n].double()
    assert float(((back - st).abs() / st.abs()).max()) <= 2.0 ** -21
    assert bool((planes[:, :, n:] == 0).all())
    assert bool(((planes.view(torch.int32) & 0x1FFF) == 0).all())


def test_dense_route_error_within_twice_fp32():
    """The dense Eq. 5 route's arithmetic (W's split, S's transposing
    split, the 3xTF32 plain product) at FedMD's weights: as close to
    fp64 as the fp32 product, within 2x; plain TF32 would not be."""
    n, r, c = 300, 24, 10
    w = torch.from_numpy(_fedmd_w(n, 34))
    probs = torch.exp(torch.from_numpy(_messengers(n, r, c, 35)))
    k_pad = -(-n // pk_mod.BK) * pk_mod.BK
    a_planes, _ = ref.pairwise_kl_split_ref(w.view(n, n, 1), False, k_pad)
    b_planes = ref.neighbor_mean_split_ref(probs, k_pad)
    got = ref.tf32x3_ref(a_planes, b_planes).double()
    exact = w.double() @ probs.reshape(n, -1).double()
    e3 = float((got - exact).abs().max())
    e32 = float((ref.neighbor_mean_ref(w, probs).reshape(n, -1).double()
                 - exact).abs().max())
    assert e3 <= 2 * e32, (e3, e32)
    e1 = float(((a_planes[0] @ b_planes[0].T).double() - exact).abs().max())
    assert e1 > 50 * e32


def test_neighbor_gather_with_no_slots_is_zero():
    """I-SGD's (N, 0) lists: zero targets, no launch, on the CPU and (by
    the wrapper's guard) before any device check."""
    ops.reset_launch_counts()
    probs = torch.exp(torch.from_numpy(_messengers(5, 6, 3, 36)))
    got = ops.neighbor_gather(torch.zeros((5, 0), dtype=torch.int32),
                              torch.zeros((5, 0)), probs)
    assert got.shape == (5, 6, 3) and float(got.abs().max()) == 0.0
    assert ops.launch_counts()["neighbor_gather"] == 0


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
# B4's two card routes: their arithmetic, emulated on the CPU
# --------------------------------------------------------------------------

def _stored_wire(n, r, c, seed):
    """(q, fp32 scale, zero zp, lse) of messengers as the IVF index
    stores them (``_encode_wire_rows``)."""
    from repro_torch.core.similarity import _encode_wire_rows
    q, s, lse = _encode_wire_rows(torch.from_numpy(_messengers(n, r, c,
                                                               seed)))
    return q, s, torch.zeros_like(s), lse


@pytest.mark.parametrize("a_side", [True, False])
def test_int8_split_ref_is_the_split_of_the_decoded_operand(a_side):
    """The dequant split's plain version is B1's split of l = q·scale −
    lse: the index's own reconstruction, and within fp32 rounding the
    codec's decode (log_softmax of q·scale + zp)."""
    r, c = 13, 5
    q, s, z = _int8_wire(_messengers(9, r, c, 31))
    lse = dk_mod.int8_row_stats(q, s)
    k_pad = -(-r * c // pk_mod.BK) * pk_mod.BK
    planes, rowterm = ref.int8_pairwise_kl_split_ref(q, s, lse, a_side,
                                                     k_pad)
    decoded = q.float() * s.float()[..., None] - lse[..., None]
    want_planes, want_rowterm = ref.pairwise_kl_split_ref(decoded, a_side,
                                                          k_pad)
    assert torch.equal(planes, want_planes)
    assert (rowterm is None) == (not a_side)
    if a_side:
        assert torch.equal(rowterm, want_rowterm)
    np.testing.assert_allclose(decoded.numpy(),
                               ref.int8_dequant_ref(q, s, z).numpy(),
                               atol=1e-5, rtol=0)


def test_int8_wide_route_matches_pallas_within_twice_fp32(pallas):
    """The wide route emulated in torch (the dequant split's TF32 planes,
    then hi hi + hi lo + lo hi) at the server's value ranges (R=240,
    C=10): within 1e-4 of the Pallas kernel in interpret mode, and its
    error against fp64 of the decoded operands at most twice the fp32
    plain version's, for the cross term and the strip."""
    r, c, u, m = 240, 10, 24, 40
    a = _int8_wire(_messengers(u, r, c, 32))
    b = _int8_wire(_messengers(m, r, c, 33))
    (qa, sa, _), (qb, sb, _) = a, b
    la, lb = dk_mod.int8_row_stats(qa, sa), dk_mod.int8_row_stats(qb, sb)
    k_pad = -(-r * c // pk_mod.BK) * pk_mod.BK
    a_planes, rowterm = ref.int8_pairwise_kl_split_ref(qa, sa, la, True,
                                                       k_pad)
    b_planes, _ = ref.int8_pairwise_kl_split_ref(qb, sb, lb, False, k_pad)
    strip3 = ref.pairwise_kl_gemm_ref(a_planes, rowterm, b_planes, r)
    want = np.asarray(pallas.dequant_kl.int8_pairwise_kl_pair(
        *_to_jax(pallas.jnp, *a), *_to_jax(pallas.jnp, *b), bn=8, bm=8,
        br=128, interpret=True))
    np.testing.assert_allclose(strip3.numpy(), want, atol=1e-4, rtol=1e-4)
    da = ref.int8_decode_ref(qa, sa, la).reshape(u, -1)
    db = ref.int8_decode_ref(qb, sb, lb).reshape(m, -1)
    pa64, da64, db64 = da.double().exp(), da.double(), db.double()
    exact = pa64 @ db64.T
    (ah, al), (bh, bl) = a_planes, b_planes
    cross3 = (ah @ bh.T + ah @ bl.T + al @ bh.T).double()
    cross32 = (da.exp() @ db.T).double()
    err3 = float((cross3 - exact).abs().max())
    err32 = float((cross32 - exact).abs().max())
    assert err3 <= 2 * err32, (err3, err32)
    truth = ((pa64 * da64).sum(1)[:, None] - exact) / r
    strip32 = dk_mod.plain(qa, sa, qb, sb, la, lb)
    e3 = float((strip3.double() - truth).abs().max())
    e32 = float((strip32.double() - truth).abs().max())
    assert e3 <= 2 * e32, (e3, e32)


def test_stored_and_recomputed_lse_strips_are_bit_equal(monkeypatch):
    """On the CPU a strip through the lse the index stores equals the
    strip that recomputes it (``int8_row_stats``, here in 2-row chunks),
    bit for bit: both are torch.logsumexp(q.float() * scale)."""
    qa, sa, za, la = _stored_wire(3, 8, 10, 34)
    qb, sb, zb, lb = _stored_wire(70, 8, 10, 35)
    monkeypatch.setattr(dk_mod, "STATS_ELEMS", 2 * 8 * 10)
    assert torch.equal(dk_mod.int8_row_stats(qb, sb), lb)
    a, b = (qa, sa, za), (qb, sb, zb)
    for (x, lx), (y, ly) in [((a, la), (b, lb)), ((b, lb), (a, la)),
                             ((b, lb), (b, lb))]:
        stored = ops.int8_pairwise_kl_pair(*x, *y, lse_a=lx, lse_b=ly)
        fresh = ops.int8_pairwise_kl_pair(*x, *y)
        assert torch.equal(stored, fresh)
    assert torch.equal(ops.int8_pairwise_kl(qb, sb, zb),
                       ops.int8_pairwise_kl_pair(qb, sb, zb, qb, sb, zb,
                                                 lse_a=lb, lse_b=lb))


def test_thin_route_takes_short_sides_whose_decode_fits():
    t = dk_mod.THIN_ROWS
    assert t == 16          # the thin kernel's own limit (dequant_kl.cu)
    assert dk_mod.thin_fits(1, 8, 10) and dk_mod.thin_fits(t, 8, 10)
    assert not dk_mod.thin_fits(0, 8, 10)
    assert not dk_mod.thin_fits(t + 1, 8, 10)
    # the server's K = 2400: THIN_ROWS rows' decode fits (169 KB); at
    # K = 4000 one row's does, THIN_ROWS rows' (282 KB) would not
    assert dk_mod.thin_fits(t, 240, 10)
    assert dk_mod.thin_fits(1, 400, 10)
    assert not dk_mod.thin_fits(t, 400, 10)


def test_int8_lse_shape_is_checked():
    q, s, z = _int8_wire(_messengers(4, 6, 3, 36))
    with pytest.raises(ValueError, match="lse_a"):
        ops.int8_pairwise_kl_pair(q, s, z, q, s, z, lse_a=torch.zeros(4, 5))
    with pytest.raises(ValueError, match="lse_b"):
        ops.int8_pairwise_kl_pair(q, s, z, q, s, z, lse_b=torch.zeros(3, 6))


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
    ops.int8_pairwise_kl_pair(q[:1], s[:1], z[:1], q, s, z)
    sizes = torch.tensor([2, 0, 3], dtype=torch.int32)
    ops.ragged_dot(t[:, 0], t[:3, :3].transpose(1, 2), sizes)
    ops.ragged_dot_wgrad(t[:, 0], t[:, 1], sizes)
    assert ops.launch_counts() == {"pairwise_kl_split": 0,
                                   "pairwise_kl_pair": 0, "soft_ce": 0,
                                   "neighbor_gather": 0, "neighbor_mean": 0,
                                   "neighbor_mean_split": 0,
                                   "int8_pairwise_kl_split": 0,
                                   "int8_pairwise_kl_thin": 0,
                                   "int8_pairwise_kl_pair": 0,
                                   "ragged_dot": 0, "ragged_dot_wgrad": 0}


@pytest.mark.parametrize("call", ["pairwise_kl", "soft_ce", "neighbor_mean",
                                  "int8_pairwise_kl", "neighbor_gather",
                                  "pairwise_kl_split",
                                  "neighbor_mean_split",
                                  "int8_pairwise_kl_split",
                                  "int8_pairwise_kl_thin"])
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
            "pairwise_kl_split": (pk_mod.split, (z, True)),
            "neighbor_mean_split": (nm_mod.split_t, (z,)),
            "int8_pairwise_kl_split": (dk_mod.split, (q, s, True)),
            "int8_pairwise_kl_thin": (dk_mod.thin, (q[:1], s[:1], q, s))}
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
                         ids=["pairwise_kl_pair", "soft_ce", "neighbor_mean",
                              "int8_pairwise_kl_pair", "neighbor_gather"])
def test_wrapper_matches_its_c_entry_point(mod):
    """Each wrapper loads a source the build compiles and declares, for
    every C entry point it calls, the argument list that entry has:
    device pointers, ints, then the stream (ctypes would otherwise
    truncate or misplace arguments). The int8 wrapper's entries are its
    split and thin kernels; its GEMM is B1's (``pairwise_kl.gemm``)."""
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
    if mod is dk_mod:
        assert set(mod.ENTRIES) == {"int8_pairwise_kl_split",
                                    "int8_pairwise_kl_thin",
                                    "int8_pairwise_kl_thin_blocks"}
        assert "dequant_kl_pair_kernel" not in src   # the FFMA tile is gone
    if mod is nm_mod:
        # the dense Eq. 5 route: the transposing split here, W's split and
        # the GEMM B1's; the FFMA tile and its header are gone
        assert set(mod.ENTRIES) == {"neighbor_mean_split"}
        assert "neighbor_mean_kernel" not in src
        assert not list(build.CSRC.glob("*.cuh"))


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
    # each Eq. 2 call splits both operands (2 launches) then runs one GEMM;
    # the dense Eq. 5 route splits W and S, then runs its GEMM
    assert ops.launch_counts() == {"pairwise_kl_split": 4,
                                   "pairwise_kl_pair": 2, "soft_ce": 1,
                                   "neighbor_gather": 1, "neighbor_mean": 1,
                                   "neighbor_mean_split": 2,
                                   "int8_pairwise_kl_split": 0,
                                   "int8_pairwise_kl_thin": 0,
                                   "int8_pairwise_kl_pair": 0,
                                   "ragged_dot": 0, "ragged_dot_wgrad": 0}


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
@pytest.mark.parametrize("shape", [(4, 8, 3), (37, 13, 5), (130, 240, 10),
                                   (257, 7, 9)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_transposing_split_matches_plain(hopper, shape, dtype):
    """S^T's planes bit for bit (no exp: the same rounding on the same
    bits), ragged N and R*C, fp32 and bf16, aligned and scalar loads."""
    n, r, c = shape
    probs = torch.exp(torch.from_numpy(_messengers(n, r, c, 37))).to(
        hopper, getattr(torch, dtype))
    got = nm_mod.split_t(probs)
    want = ref.neighbor_mean_split_ref(probs, got.planes.shape[2])
    torch.cuda.synchronize()
    assert got.planes.shape[2] % pk_mod.BK == 0 and got.rowterm is None
    assert torch.equal(got.planes, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,rc", [(4, 24), (37, 65), (300, 2400),
                                  (129, 257)])
def test_cuda_plain_store_gemm_matches_plain(hopper, n, rc):
    """B1's GEMM in its plain-store mode on the dense route's planes, and
    the route as ``ops.neighbor_mean`` runs it, against their plain
    versions on FedMD's weights; launches counted under neighbor_mean."""
    w = torch.from_numpy(_fedmd_w(n, 38)).to(hopper)
    probs = torch.from_numpy(np.random.default_rng(39).random(
        (n, rc, 1), dtype=np.float32)).to(hopper)
    a, b = nm_mod.split_w(w), nm_mod.split_t(probs)
    got = pk_mod.gemm(a, b)
    want = ref.tf32x3_ref(a.planes, b.planes)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-6, rtol=1e-5)
    ops.reset_launch_counts()
    t = ops.neighbor_mean(w, probs)
    np.testing.assert_allclose(t.cpu().numpy(),
                               ref.neighbor_mean_ref(w, probs).cpu().numpy(),
                               atol=1e-5, rtol=1e-5)
    counts = ops.launch_counts()
    assert counts["neighbor_mean"] == 1 and counts["neighbor_mean_split"] == 2
    assert counts["pairwise_kl_split"] == counts["pairwise_kl_pair"] == 0


@pytest.mark.gpu
def test_cuda_neighbor_gather_with_no_slots_launches_nothing(hopper):
    ops.reset_launch_counts()
    probs = torch.ones((6, 4, 3), device=hopper)
    got = ops.neighbor_gather(torch.zeros((6, 0), dtype=torch.int32,
                                          device=hopper),
                              torch.zeros((6, 0), device=hopper), probs)
    assert got.is_cuda and float(got.abs().max()) == 0.0
    assert ops.launch_counts()["neighbor_gather"] == 0


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


def _int8_card(dev, n, r, c, seed):
    """(q, fp32 scale, zp, lse) on the card: the payload's wire arrays and
    the row statistics the plain version computes."""
    q, s, z = (t.to(dev) for t in _int8_wire(_messengers(n, r, c, seed)))
    s = s.float()
    return q, s, z, dk_mod.int8_row_stats(q, s)


@pytest.mark.gpu
@pytest.mark.parametrize("rc", [(37, 13), (240, 10)])
@pytest.mark.parametrize("given", [True, False],
                         ids=["stored_lse", "computed_lse"])
@pytest.mark.parametrize("a_side", [True, False])
def test_cuda_int8_split_matches_plain(hopper, rc, given, a_side):
    """The dequant split against its plain version, on the scalar (K =
    481) and 4-wide (K = 2400) paths: every plane value a TF32; with the
    stored lse the B side's planes bit for bit, the A side's hi + lo
    within 1e-6 relative (exp may differ in a last bit) and its row term
    within 1e-5; a computed lse within 1e-6 of torch.logsumexp's."""
    q, s, _, lse = _int8_card(hopper, 70, *rc, 37)
    got, got_lse = dk_mod.split(q, s, a_side, lse if given else None)
    planes, rowterm = ref.int8_pairwise_kl_split_ref(q, s, lse, a_side,
                                                     got.planes.shape[2])
    torch.cuda.synchronize()
    assert bool(((got.planes.view(torch.int32) & 0x1FFF) == 0).all())
    np.testing.assert_allclose(got_lse.cpu().numpy(), lse.cpu().numpy(),
                               atol=1e-6, rtol=1e-6)
    if given and not a_side:
        assert torch.equal(got.planes, planes) and got.rowterm is None
    else:
        rtol = 1e-6 if given else 1e-5
        np.testing.assert_allclose(got.planes.sum(0).cpu().numpy(),
                                   planes.sum(0).cpu().numpy(),
                                   atol=1e-5 * (not given), rtol=rtol)
    if a_side:
        np.testing.assert_allclose(got.rowterm.cpu().numpy(),
                                   rowterm.cpu().numpy(), rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("u,m,rc", [(1, 1000, (8, 10)), (1000, 1, (8, 10)),
                                    ("thin", 1000, (8, 10)),
                                    (1000, "thin", (8, 10)),
                                    (13, 37, (13, 5)), (37, 13, (13, 5)),
                                    (1, 300, (240, 10))])
@pytest.mark.parametrize("given", [True, False],
                         ids=["stored_lse", "computed_lse"])
def test_cuda_int8_thin_matches_plain(hopper, u, m, rc, given):
    """The thin kernel in both orientations (1 x m, m x 1, THIN_ROWS x m,
    m x THIN_ROWS, THIN_ROWS being its largest thin side), ragged
    (K = 65, scalar loads) and at the server's K = 2400, against the plain
    version within (1e-4, 1e-4); one launch each."""
    rows = {"thin": dk_mod.THIN_ROWS}
    u, m = rows.get(u, u), rows.get(m, m)
    qa, sa, za, la = _int8_card(hopper, u, *rc, 38)
    qb, sb, zb, lb = _int8_card(hopper, m, *rc, 39)
    ops.reset_launch_counts()
    got = dk_mod.thin(qa, sa, qb, sb, *((la, lb) if given else ()))
    want = ref.int8_pairwise_kl_pair_ref(qa, sa, za, qb, sb, zb)
    torch.cuda.synchronize()
    assert got.shape == (u, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    assert ops.launch_counts()["int8_pairwise_kl_thin"] == 1


@pytest.mark.gpu
def test_cuda_int8_wide_strip_error_within_twice_fp32(hopper):
    """A server-sized int8 strip (256 x 512, R=240, C=10) takes the wide
    route (two dequant splits, one 3xTF32 GEMM) and its error against fp64
    of the decoded operands is at most twice the fp32 plain version's."""
    qa, sa, za, la = _int8_card(hopper, 256, 240, 10, 40)
    qb, sb, zb, lb = _int8_card(hopper, 512, 240, 10, 41)
    ops.reset_launch_counts()
    got = ops.int8_pairwise_kl_pair(qa, sa, za, qb, sb, zb, lse_a=la,
                                    lse_b=lb).double()
    counts = ops.launch_counts()
    assert (counts["int8_pairwise_kl_split"], counts["int8_pairwise_kl_pair"],
            counts["int8_pairwise_kl_thin"], counts["pairwise_kl_pair"]) \
        == (2, 1, 0, 0)
    plain = dk_mod.plain(qa, sa, qb, sb, la, lb).double()
    da = ref.int8_decode_ref(qa, sa, la).reshape(256, -1).double()
    db = ref.int8_decode_ref(qb, sb, lb).reshape(512, -1).double()
    pa = da.exp()
    truth = ((pa * da).sum(1)[:, None] - pa @ db.T) / 240
    e_kern = float((got - truth).abs().max())
    e_plain = float((plain - truth).abs().max())
    assert e_kern <= 2 * e_plain, (e_kern, e_plain)
    np.testing.assert_allclose(
        got.cpu().numpy(),
        ref.int8_pairwise_kl_pair_ref(qa, sa, za, qb, sb, zb).cpu().numpy(),
        atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES + [(1, 8, 10), (300, 8, 10)])
def test_cuda_int8_kernel_matches_plain(hopper, shape):
    """B4 against its plain version on the card, bf16 wire scale, square
    and both strip orientations (1 x m and m x 1 included). The square
    splits the repository once for each side and runs one GEMM a
    CHUNK_ROWS strip; each one-row strip is one thin launch."""
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
    counts = ops.launch_counts()
    assert (counts["int8_pairwise_kl_split"], counts["int8_pairwise_kl_pair"],
            counts["int8_pairwise_kl_thin"]) == (2, 1, 2)
    assert counts["pairwise_kl_split"] == counts["pairwise_kl_pair"] == 0


@pytest.mark.gpu
def test_cuda_index_upload_reads_the_stored_lse(hopper, monkeypatch):
    """An IVF upload on the card runs its strips through the thin kernel
    on the lse the index stores: the plain version's row statistics are
    never computed, and no strip falls to the wide route."""
    from repro_torch.core import NeighborIndex
    rng = np.random.default_rng(42)
    n = 4000
    idx = NeighborIndex(n, 8, 10, k=5, device=hopper)
    idx.ingest_only(np.arange(n), torch.from_numpy(_messengers(n, 8, 10, 43)))
    idx.refresh()

    def recompute(*args):
        raise AssertionError("an upload recomputed the row statistics")

    monkeypatch.setattr(dk_mod, "int8_row_stats", recompute)
    ops.reset_launch_counts()
    idx.update(rng.integers(0, n, size=1),
               torch.from_numpy(_messengers(1, 8, 10, 44)))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["int8_pairwise_kl_thin"] >= 2      # forward and reverse
    assert counts["int8_pairwise_kl_split"] == 0
