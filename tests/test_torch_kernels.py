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
from repro_torch.kernels import dequant_kl as dk_mod
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


def test_cpu_calls_count_no_launches():
    ops.reset_launch_counts()
    t = torch.from_numpy(_messengers(5, 6, 3, 7))
    ops.pairwise_kl(t)
    ops.soft_ce(t, torch.zeros(6, dtype=torch.int32))
    ops.neighbor_mean(torch.eye(5), torch.exp(t))
    q, s, z = _int8_wire(_messengers(5, 6, 3, 7))
    ops.int8_pairwise_kl(q, s, z)
    assert ops.launch_counts() == {"pairwise_kl_pair": 0, "soft_ce": 0,
                                   "neighbor_mean": 0,
                                   "int8_pairwise_kl_pair": 0}


@pytest.mark.parametrize("call", ["pairwise_kl", "soft_ce", "neighbor_mean",
                                  "int8_pairwise_kl"])
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
                                 (q, s, s, q, s, s))}
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


@pytest.mark.parametrize("mod", [pk_mod, sc_mod, nm_mod, dk_mod],
                         ids=lambda m: m.ENTRY)
def test_wrapper_matches_its_c_entry_point(mod):
    """Each wrapper loads a source the build compiles and declares the
    argument list its C entry point has: device pointers, ints, then the
    stream (ctypes would otherwise truncate or misplace arguments)."""
    assert mod.SOURCE in build.SOURCES
    src = (build.CSRC / f"{mod.SOURCE}.cu").read_text()
    sig = re.search(r'extern "C" int ' + mod.ENTRY + r"\(([^)]*)\)", src)
    assert sig is not None
    params = [p.strip() for p in sig.group(1).split(",")]
    n_ptr, n_int = mod.ARGS
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
    probs = torch.exp(logp.float()).to(dt)
    ops.reset_launch_counts()
    for got, want, tol in [
            (ops.pairwise_kl(logp), ref.pairwise_kl_ref(logp), 1e-5),
            (ops.pairwise_kl_pair(half, logp),
             ref.pairwise_kl_pair_ref(half, logp), 1e-5),
            (ops.soft_ce(logp, labels), ref.soft_ce_ref(logp, labels), 1e-4),
            (ops.neighbor_mean(w, probs), ref.neighbor_mean_ref(w, probs),
             1e-5)]:
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=tol, rtol=tol)
    assert ops.launch_counts() == {"pairwise_kl_pair": 2, "soft_ce": 1,
                                   "neighbor_mean": 1,
                                   "int8_pairwise_kl_pair": 0}


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
