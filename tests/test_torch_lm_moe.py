"""The port's MoE FFN and MLA against live runs of the reference's.

The reduced ``mixtral-smoke`` (4 experts, top 2) and ``dsv2-smoke`` (4
routed experts, top 2, one shared; MLA with ranks 64 and 48) configs,
with the reference's own params (``init_moe``, ``init_mla``) carried
across by ``repro_torch.convert`` and the same numpy inputs on both
sides. ``route``'s expert indices are equal exactly: every seeded input
asserts a router margin above 1e-4 between the k-th and the (k+1)-th
logit, so an index mismatch is a fault, never noise; a constructed tie
goes to the lowest index. The MoE paths (GShard with choices dropped,
GShard with a capacity wide enough to equal dropless, dropless, decode)
and MLA (forward with its latents, decode up to and past a full cache,
the cache's packing) agree within REL of the largest output in fp32 and
BF16_REL in bf16 (the frameworks round bf16 at different points). The
reference's bf16 GShard cannot run on XLA's CPU runtime (no bf16 x bf16
-> fp32 batched product), so the port's is held against the reference's
fp32 GShard on the same bf16 values.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import attention as JA
from repro.models import cache as JCACHE
from repro.models import ffn as JF
from repro_torch import configs as TC
from repro_torch.convert import lm_tree_from_numpy, lm_tree_to_numpy
from repro_torch.models import attention as TA
from repro_torch.models import cache as TCACHE
from repro_torch.models import ffn as TF

CPU = torch.device("cpu")
REL = 1e-4
BF16_REL = 3e-2
MARGIN = 1e-4
EXPERT = ("mixtral-8x7b", "deepseek-v2-236b")
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _to_port(a):
    return lm_tree_from_numpy(np.asarray(a), CPU)


def _from_port(t):
    a = lm_tree_to_numpy(t)
    return a.view(ml_dtypes.bfloat16) if t.dtype == torch.bfloat16 else a


def _configs(arch, dtype="fp32", **kw):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(JC.get_reduced(arch), param_dtype=jdt, **kw),
            dataclasses.replace(TC.get_reduced(arch), param_dtype=tdt, **kw))


def _params(init_fn, cfg, seed=0):
    """The reference's params as numpy, and as the port's tensors."""
    p = jax.tree.map(np.asarray, init_fn(jax.random.key(seed), cfg))
    return p, lm_tree_from_numpy(p, CPU)


def _inputs(cfg, shape, seed, shift=0.0):
    x = np.random.default_rng(seed).normal(size=shape) + shift
    return np.asarray(jnp.asarray(x, cfg.param_dtype))


def _assert_margin(p, cfg, x):
    """Every token's k-th router logit clears the (k+1)-th by MARGIN, so
    the two packages pick the same experts."""
    logits = np.asarray(x, np.float64) @ np.asarray(p["router"], np.float64)
    top = -np.sort(-logits, axis=-1)
    k = cfg.moe_top_k
    assert float((top[..., k - 1] - top[..., k]).min()) > MARGIN


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", EXPERT)
def test_route_matches_reference(arch):
    jcfg, tcfg = _configs(arch)
    p, tp = _params(JF.init_moe, jcfg)
    x = _inputs(jcfg, (2, 24, jcfg.d_model), 1)
    _assert_margin(p, jcfg, x)
    weights, idx, aux = JF.route(p, jcfg, x)
    tw, ti, ta = TF.route(tp, tcfg, _to_port(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    assert tw.dtype == ta.dtype == torch.float32
    np.testing.assert_allclose(tw.numpy(), weights, rtol=0, atol=1e-5)
    assert abs(float(ta) - float(aux)) <= 1e-5


def test_route_ties_go_to_the_lowest_index():
    """Equal router columns give equal logits: the top 2 of [l, h, h, h]
    are experts 1 and 2, and of all-equal logits 0 and 1, as the
    reference's ``jax.lax.top_k`` picks them."""
    jcfg, tcfg = _configs("mixtral-8x7b")
    d = jcfg.d_model
    w = np.full((d,), 1.0 / d, np.float32)
    x = np.abs(_inputs(jcfg, (2, 3, d), 2)) + 0.1
    for router, want in ((np.stack([w, 2 * w, 2 * w, 2 * w], 1), [1, 2]),
                         (np.zeros((d, 4), np.float32), [0, 1])):
        _, idx, _ = JF.route({"router": router}, jcfg, x)
        _, ti, _ = TF.route({"router": _to_port(router)}, tcfg, _to_port(x))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
        assert (ti.reshape(-1, 2) == torch.tensor(want)).all()


# --------------------------------------------------------------------------
# the MoE paths
# --------------------------------------------------------------------------

def _gshard(cf):
    def run(fn, p, cfg, x):
        return fn(p, cfg, x, capacity_factor=cf)
    return run


MOE_PATHS = {
    # expert 0 favoured by every token: 24 tokens x 2 choices on 4
    # experts of 16 slots, so expert 0 drops choices
    "gshard-drops": (JF.moe_gshard_forward, TF.moe_gshard_forward,
                     _gshard(1.25), 24, 3.0),
    # 48 slots, more than the 24 tokens: nothing dropped, the dropless
    # result
    "gshard-wide": (JF.moe_gshard_forward, TF.moe_gshard_forward,
                    _gshard(4.0), 24, 0.0),
    "dropless": (JF.moe_dropless_forward, TF.moe_dropless_forward,
                 None, 24, 0.0),
    "decode": (JF.moe_decode, TF.moe_decode, None, 1, 0.0),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("path", list(MOE_PATHS))
@pytest.mark.parametrize("arch", EXPERT)
def test_moe_path_matches_reference(arch, path, dtype):
    jfn, tfn, call, s, favour = MOE_PATHS[path]
    jcfg, tcfg = _configs(arch, dtype)
    p, tp = _params(JF.init_moe, jcfg)
    if favour:
        p["router"] = p["router"].copy()
        p["router"][:, 0] += favour / np.sqrt(jcfg.d_model)
        tp = lm_tree_from_numpy(p, CPU)
    x = _inputs(jcfg, (2, s, jcfg.d_model), 3, shift=0.5 if favour else 0.0)
    _assert_margin(p, jcfg, x)
    call = call or (lambda fn, *a: fn(*a))
    got, taux = call(tfn, tp, tcfg, _to_port(x))
    if dtype == "bf16" and path.startswith("gshard"):
        # XLA's CPU runtime (jax 0.9.0) has no bf16 x bf16 -> fp32 batched
        # product (GShard's ``ye``, "Unsupported element type for
        # DotThunk"): the reference runs in fp32 on the same bf16 values
        p, x = jax.tree.map(lambda a: np.asarray(a, np.float32), (p, x))
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.float32)
    want, aux = jax.jit(lambda p_, x_: call(jfn, p_, jcfg, x_))(p, x)
    assert got.dtype == DTYPES[dtype][1] and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    rel = REL if dtype == "fp32" else BF16_REL
    _close(got.float().numpy(), np.asarray(want, np.float32), rel)
    assert abs(float(taux) - float(aux)) <= 1e-5
    if path.startswith("gshard"):
        dropless, _ = jax.jit(lambda p_, x_: JF.moe_dropless_forward(
            p_, jcfg, x_))(p, x)
        gap = np.abs(np.asarray(want, np.float64)
                     - np.asarray(dropless, np.float64)).max()
        scale = np.abs(np.asarray(dropless, np.float64)).max()
        if path == "gshard-drops":
            assert gap > 0.05 * scale, "no choice was dropped"
        else:
            assert gap <= rel * scale


def test_gshard_capacity_is_the_reference_rounding():
    """Python's round (16.5 -> 16, not 17) and the multiple of 16, at the
    test shape and at the two architectures' serve shapes (96 tokens)."""
    for arch, s, want in (("mixtral-8x7b", 20, 16), ("mixtral-8x7b", 96, 32),
                          ("deepseek-v2-236b", 96, 16)):
        full = TC.get_config(arch) if s == 96 else TC.get_reduced(arch)
        assert TF.gshard_capacity(full, s) == want
    cfg = TC.get_reduced("mixtral-8x7b")
    assert TF.gshard_capacity(cfg, 44, 0.75) == 16       # round(16.5) = 16
    assert TF.gshard_capacity(cfg, 44, 0.8) == 32        # 17.6 -> 18 -> 32


def test_moe_decode_rejects_more_than_one_token():
    jcfg, tcfg = _configs("mixtral-8x7b")
    _, tp = _params(JF.init_moe, jcfg)
    with pytest.raises(ValueError, match="one token per row"):
        TF.moe_decode(tp, tcfg, torch.zeros((2, 3, jcfg.d_model)))
    with pytest.raises(ValueError, match="unknown moe path"):
        TF.moe_forward(tp, tcfg, torch.zeros((2, 3, jcfg.d_model)), "dense")


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

QRANKS = {"q-lora": 48, "q-dense": 0}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("qrank", list(QRANKS))
def test_mla_forward_matches_reference(qrank, dtype):
    """10 positions with the latents returned: the output, ckv and the
    roped krope in x's dtype."""
    jcfg, tcfg = _configs("deepseek-v2-236b", dtype,
                          q_lora_rank=QRANKS[qrank])
    p, tp = _params(JA.init_mla, jcfg, seed=1)
    assert ("w_dq" in tp) == (qrank == "q-lora") and ("wq" in tp) != (
        qrank == "q-lora")
    x = _inputs(jcfg, (2, 10, jcfg.d_model), 4)
    pos = np.arange(10, dtype=np.int32)
    want, (ckv, krope) = JA.mla_forward(p, jcfg, x, pos, return_kv=True)
    got, (tckv, tkrope) = TA.mla_forward(tp, tcfg, _to_port(x),
                                         _to_port(pos), return_kv=True)
    rel = REL if dtype == "fp32" else BF16_REL
    for a, b in ((got, want), (tckv, ckv), (tkrope, krope)):
        assert a.dtype == DTYPES[dtype][1] and a.shape == b.shape
        _close(a.float().numpy(), np.asarray(b, np.float32), rel)
    assert torch.equal(TA.mla_forward(tp, tcfg, _to_port(x), _to_port(pos)),
                       got)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("qrank", list(QRANKS))
def test_mla_decode_matches_reference(qrank, dtype):
    """Four one-token steps from the reference's 6-token prefill packed
    into 8 slots: positions 6 and 7 fill the cache, 8 and 9 overwrite its
    last slot (min(pos, S - 1)). Each step's output and the whole cache
    against the reference's, positions exactly."""
    jcfg, tcfg = _configs("deepseek-v2-236b", dtype,
                          q_lora_rank=QRANKS[qrank])
    p, tp = _params(JA.init_mla, jcfg, seed=1)
    x = _inputs(jcfg, (2, 6, jcfg.d_model), 5)
    _, (ckv, krope) = JA.mla_forward(p, jcfg, x, np.arange(6, dtype=np.int32),
                                     return_kv=True)
    cache = jax.tree.map(np.asarray, JCACHE.mla_kv_to_cache(ckv, krope, 8))
    tcache = lm_tree_from_numpy(cache, CPU)
    rel = REL if dtype == "fp32" else BF16_REL
    for step in range(4):
        x1 = _inputs(jcfg, (2, 1, jcfg.d_model), 10 + step)
        want, cache = JA.mla_decode(p, jcfg, x1, cache)
        got, tcache = TA.mla_decode(tp, tcfg, _to_port(x1), tcache)
        _close(got.float().numpy(), np.asarray(want, np.float32), rel)
        for key in ("ckv", "krope"):
            assert tcache[key].dtype == DTYPES[dtype][1]
            _close(tcache[key].float().numpy(),
                   np.asarray(cache[key], np.float32), rel)
        for key in ("k_pos", "pos"):
            np.testing.assert_array_equal(tcache[key].numpy(), cache[key])
            assert tcache[key].dtype == torch.int32
    assert int(tcache["pos"]) == 10 and tcache["k_pos"].tolist() == [
        0, 1, 2, 3, 4, 5, 6, 9]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_cache_packing_matches_reference(dtype):
    """``mla_kv_to_cache`` and the empty ``layer_cache("mla")``: every
    leaf's shape, dtype and bits."""
    jcfg, tcfg = _configs("deepseek-v2-236b", dtype)
    r, rh = jcfg.kv_lora_rank, jcfg.rope_head_dim
    ckv = _inputs(jcfg, (2, 5, r), 6)
    krope = _inputs(jcfg, (2, 5, rh), 7)
    cases = ((JCACHE.mla_kv_to_cache(ckv, krope, 9),
              TCACHE.mla_kv_to_cache(_to_port(ckv), _to_port(krope), 9)),
             (JCACHE.layer_cache(jcfg, "mla", 2, 9, jcfg.param_dtype),
              TCACHE.layer_cache(tcfg, "mla", 2, 9, tcfg.param_dtype)))
    for want, got in cases:
        assert set(got) == set(want) == {"ckv", "krope", "k_pos", "pos"}
        for key in want:
            a, b = _from_port(got[key]), np.asarray(want[key])
            assert a.dtype == b.dtype and a.shape == b.shape, key
            np.testing.assert_array_equal(a, b, err_msg=key)
    assert TCACHE.cache_window(tcfg, "mla", 9) == 9
