"""The port's LM training loss and its gradients against the reference's.

Every architecture at its reduced size with fp32 params (the reference's
``init_params``, vectors and biases moved off their trivial init by
numpy noise, carried across by ``repro_torch.convert``): ``lm_loss``'s
loss, ce, aux and the gradient of every leaf against
``jax.value_and_grad(lm_loss)`` on the same batch, the MoE architectures
on both paths (GShard's gradients pass through the dispatch one-hots,
the dropless path's through its per-expert slices and scatters), the
frontends' frames in front of the tokens (the loss on the text tail),
every layer kind (global, local, mla, ssd, rec) included. The grads of
``remat=True`` equal those of ``remat=False``. ``token_ce_loss`` with and
without a mask.

Tolerances: losses within 1e-5 relative; each gradient leaf within GRAD
of its largest magnitude (fp32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import transformer as JT
from repro.models.frontends import frontend_dim
from repro_torch import configs as TC
from repro_torch.convert import lm_tree_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_unflatten

CPU = torch.device("cpu")
GRAD = 1e-4
LOSS = 1e-5
EXPERT = ("mixtral-8x7b", "deepseek-v2-236b")
CASES = [(a, "gshard") for a in JC.ARCH_IDS] + [(a, "dropless")
                                               for a in EXPERT]
BATCH, SEQ, FRAMES = 2, 20, 3
_NUDGED = {"scale", "bq", "bk", "bv", "conv_b", "b_a", "b_i", "dt_bias",
           "a_log", "d_skip", "norm_scale"}


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_cache():
    jax.clear_caches()


def _configs(arch):
    return (dataclasses.replace(JC.get_reduced(arch),
                                param_dtype=jnp.float32),
            dataclasses.replace(TC.get_reduced(arch),
                                param_dtype=torch.float32))


def _reference_params(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def nudge(path, leaf):
        a = np.asarray(leaf)
        if getattr(path[-1], "key", None) in _NUDGED:
            a = (a.astype(np.float32)
                 + 0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(
        nudge, JT.init_params(jax.random.key(seed), cfg))


def _batch(cfg, seed=1):
    """Tokens and next-token labels; with a frontend, FRAMES frames of
    embeds in front, so the logits are longer than the labels."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    b = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    if cfg.frontend is not None:
        b["embeds"] = rng.normal(size=(BATCH, FRAMES, frontend_dim(
            cfg.frontend))).astype(np.float32)
    return b


def _port(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_loss_and_grads(params, cfg, batch, moe_path, remat=False):
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss, (ce, aux) = TT.lm_loss(tree_unflatten(params, leaves), cfg, batch,
                                 moe_path=moe_path, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return (float(loss.detach()), float(ce.detach()), float(aux.detach()),
            grads)


def _close_rel(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


@pytest.mark.parametrize("arch,moe_path", CASES)
def test_lm_loss_and_grads_match_reference(arch, moe_path):
    jcfg, tcfg = _configs(arch)
    params = _reference_params(jcfg)
    batch = _batch(jcfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, jcfg, b, moe_path=moe_path),
        has_aux=True))
    (loss, (ce, aux)), grads = fn(params, batch)
    got = _port_loss_and_grads(lm_tree_from_numpy(params, CPU), tcfg,
                               _port(batch), moe_path)
    for g, w, name in zip(got[:3], (loss, ce, aux), ("loss", "ce", "aux")):
        assert abs(g - float(w)) <= LOSS * max(abs(float(w)), 1.0), name
    assert (float(aux) > 0.0) == (arch in EXPERT)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(grads)[0]]
    want = jax.tree.leaves(grads)
    assert len(got[3]) == len(want)
    for g, w, path in zip(got[3], want, paths):
        assert tuple(g.shape) == w.shape, path
        _close_rel(g.numpy(), w, GRAD, path)


@pytest.mark.parametrize("arch,moe_path", CASES)
def test_remat_grads_equal_plain_grads(arch, moe_path, monkeypatch):
    """Activation checkpoints of each layer group and remainder layer
    recompute the same forward: loss and every grad equal, bit for bit,
    and under remat the backward runs every layer a second time."""
    _, tcfg = _configs(arch)
    params = TT.init_params(tcfg, CPU, torch.Generator().manual_seed(5))
    batch = _port(_batch(tcfg, seed=6))
    calls, apply_layer = [], TT.apply_layer

    def counted(*args, **kw):
        calls.append(args[2])
        return apply_layer(*args, **kw)

    monkeypatch.setattr(TT, "apply_layer", counted)
    plain = _port_loss_and_grads(params, tcfg, batch, moe_path)
    assert len(calls) == tcfg.n_layers
    remat = _port_loss_and_grads(params, tcfg, batch, moe_path, remat=True)
    assert len(calls) == 3 * tcfg.n_layers
    assert plain[:3] == remat[:3]
    for a, b in zip(plain[3], remat[3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_token_ce_loss_matches_reference(masked):
    rng = np.random.default_rng(7)
    logits = (3.0 * rng.normal(size=(3, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) < 0.6) if masked else None
    want = JT.token_ce_loss(logits, labels, mask)
    got = TT.token_ce_loss(torch.from_numpy(logits),
                           torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    if masked:
        # an all-zero mask divides by max(0, 1): the loss is 0, not NaN
        zero = TT.token_ce_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                torch.zeros((3, 9), dtype=torch.bool))
        assert float(zero) == 0.0 == float(JT.token_ce_loss(
            logits, labels, np.zeros((3, 9), bool)))
