"""The port's optimizers and schedules against the reference's
``repro.optim``.

The reference steps one client at a time under ``jax.vmap``; the port
steps a cohort's stacked params with a per-client ``(n_c,)`` step
counter. The same numpy-seeded params and gradients go through both for
several steps. Updates, moments and params agree to 1e-6 absolute and
relative: the two frameworks round ``pow``, ``sqrt`` and the divisions in
the last fp32 bit. A gated client keeps every state leaf bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as J
import repro_torch.optim as T
from repro_torch.core.client import cohort_step
from repro_torch.models import build_zoo

N_C = 3
SHAPES = [(4, 5), (7,), (2, 3, 2)]
TOL = dict(rtol=1e-6, atol=1e-6)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(N_C, *s)) * scale).astype(np.float32)
            for s in SHAPES]


def _leaves(state):
    """Every state leaf of a reference state as numpy, in field order."""
    return [np.asarray(x) for x in jax.tree.leaves(state)]


OPTIMIZERS = {
    "sgd": lambda M: M.sgd(0.05),
    "sgd-momentum": lambda M: M.sgd(0.05, momentum=0.9),
    "adam": lambda M: M.adam(3e-3),
    "adamw": lambda M: M.adamw(1e-2, weight_decay=0.1),
    "adam-warmup-cosine": lambda M: M.adam(M.warmup_cosine(3e-3, 2, 6)),
    "sgd-cosine": lambda M: M.sgd(M.cosine_decay(0.1, 4, alpha=0.1),
                                  momentum=0.5),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_updates_and_state_match_reference_over_steps(name):
    jopt, topt = OPTIMIZERS[name](J), OPTIMIZERS[name](T)
    params = _tree(0)
    jparams = [jnp.asarray(p) for p in params]
    tparams = [torch.from_numpy(p) for p in params]
    jstate = jax.vmap(jopt.init)(jparams)
    tstate = topt.init(tparams)
    for step in range(5):
        grads = _tree(10 + step, scale=0.1)
        # a gradient element at exactly zero and one far below eps
        grads[0][:, 0, 0] = 0.0
        grads[0][:, 0, 1] = 1e-12
        jup, jstate = jax.vmap(jopt.update)(
            [jnp.asarray(g) for g in grads], jstate, jparams)
        tup, tstate = topt.update([torch.from_numpy(g) for g in grads],
                                  tstate, tparams)
        for a, b in zip(tup, jup):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        jparams = J.apply_updates(jparams, jup)
        tparams = T.apply_updates(tparams, tup)
    for a, b in zip(T.state_tensors(tstate), _leaves(jstate)):
        assert a.dtype == (torch.int32 if b.dtype == np.int32
                           else torch.float32)
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    np.testing.assert_array_equal(tstate.step.numpy(), np.full(N_C, 5))
    for a, b in zip(tparams, jparams):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_plain_sgd_keeps_no_momentum_like_the_reference():
    state = T.sgd(0.1).init([torch.zeros(N_C, 2)])
    assert state.momentum is None
    assert jax.vmap(J.sgd(0.1).init)([jnp.zeros((N_C, 2))]).momentum is None
    assert len(T.state_tensors(state)) == 1


def test_adamw_needs_params():
    opt = T.adamw(1e-3)
    p = [torch.zeros(N_C, 2)]
    with pytest.raises(ValueError, match="needs params"):
        opt.update(p, opt.init(p))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_is_per_client(max_norm):
    grads = _tree(3)
    jclip, jgn = jax.vmap(lambda g: J.clip_by_global_norm(g, max_norm))(
        [jnp.asarray(g) for g in grads])
    tclip, tgn = T.clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                       max_norm)
    np.testing.assert_allclose(tgn.numpy(), np.asarray(jgn), **TOL)
    for a, b in zip(tclip, jclip):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("make", [
    lambda M: M.constant(0.3),
    lambda M: M.linear_warmup(0.1, 4),
    lambda M: M.linear_warmup(0.1, 0),
    lambda M: M.cosine_decay(0.2, 6),
    lambda M: M.cosine_decay(0.2, 6, alpha=0.25),
    lambda M: M.warmup_cosine(0.1, 3, 9, alpha=0.1)])
def test_schedules_match_reference(make):
    steps = np.arange(12, dtype=np.int32)
    want = np.asarray(jax.vmap(make(J))(jnp.asarray(steps)))
    got = make(T)(torch.from_numpy(steps))
    assert got.dtype == torch.float32 and got.shape == (12,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_gated_client_keeps_every_state_leaf_bit_for_bit():
    """A transformer cohort on Adam: rows outside the trainable mask keep
    their params, both moments and their step counter across steps in
    which the other rows move."""
    l, c, n_c = 16, 3, 4
    model = build_zoo("transformer", l, c)["transformer"](
        n_c, device=torch.device("cpu"),
        generator=torch.Generator().manual_seed(0))
    opt = T.adam(3e-3)
    state = opt.init(list(model.parameters()))
    rng = np.random.default_rng(5)
    masks = [np.array([1, 0, 1, 1], bool), np.array([1, 0, 0, 1], bool)]
    for i, on in enumerate(masks):
        if i == 1:
            before_p = [p.detach().clone() for p in model.parameters()]
            before_s = [t.clone() for t in T.state_tensors(state)]
        x = torch.from_numpy(rng.normal(size=(n_c, 6, l)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, c, (n_c, 6)))
        ref_x = torch.from_numpy(rng.normal(size=(5, l)).astype(np.float32))
        t = torch.full((n_c, 5, c), 1.0 / c)
        state, _ = cohort_step(model, opt, state, x, y, ref_x, t,
                               torch.from_numpy(on), 0.8, True)
    np.testing.assert_array_equal(state.step.numpy(), [2, 0, 1, 2])
    frozen = ~masks[1]
    moved = masks[1]
    for a, b in zip(before_p, model.parameters()):
        assert torch.equal(a[frozen], b.detach()[frozen])
        assert not torch.equal(a[moved], b.detach()[moved])
    for a, b in zip(before_s, T.state_tensors(state)):
        assert torch.equal(a[frozen], b[frozen])
    # client 1 never trained: its moments are still exactly zero
    for m in state.mu + state.nu:
        assert float(m[1].abs().sum()) == 0.0
