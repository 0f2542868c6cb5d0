"""The port's client side against the reference's.

One ``cohort_step`` from identical params, batch and targets must give
the reference's params, momentum, step counter and loss, to fp32
rounding (the two frameworks order their matmul sums differently: 1e-6
absolute / 1e-5 relative). Rows outside the trainable mask must come out
bit-identical to what went in, every optimizer-state leaf included. The
numpy-only data and schedule modules must reproduce the reference
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.client import cohort_accuracy as jax_cohort_accuracy
from repro.core.client import \
    cohort_accuracy_masked as jax_cohort_accuracy_masked
from repro.core.client import cohort_step as jax_cohort_step
from repro.core.messenger import cohort_messengers as jax_cohort_messengers
from repro.core.schedules import StagedJoin as JaxStagedJoin
from repro.data import make_splits as jax_make_splits
from repro.data import pack_cohort as jax_pack_cohort
from repro.data import pad_like as jax_pad_like
from repro.data import sc_like as jax_sc_like
from repro.data.pipeline import cohort_batch as jax_cohort_batch
from repro.models.mlp import hetero_mlp_zoo as jax_zoo
from repro.optim import sgd as jax_sgd
from repro_torch.convert import cohort_params_from_numpy
from repro_torch.core.client import (cohort_accuracy, cohort_accuracy_masked,
                                     cohort_messenger_upload, cohort_pred,
                                     cohort_step)
from repro_torch.core.schedules import StagedJoin
from repro_torch.data import (cohort_batch, make_splits, pack_cohort,
                              pad_like, sc_like)
from repro_torch.models import CohortMLP, hetero_mlp_zoo
from repro_torch.optim import sgd

N_C, B, R, L, C = 5, 6, 7, 12, 3
RHO = 0.8


def _jax_cohort(family, seed):
    init_fn, apply_fn = jax_zoo(L, C)[family]
    params = jax.vmap(init_fn)(jax.random.split(jax.random.key(seed), N_C))
    return apply_fn, params


def _port_cohort(family, jparams):
    model = CohortMLP(hetero_mlp_zoo(L, C)[family], N_C, device="cpu")
    model.load_layers(cohort_params_from_numpy(
        jax.tree.map(np.asarray, jparams)))
    return model


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_C, B, L)).astype(np.float32)
    y = rng.integers(0, C, (N_C, B)).astype(np.int32)
    ref_x = rng.normal(size=(R, L)).astype(np.float32)
    t = rng.random((N_C, R, C)).astype(np.float32)
    t /= t.sum(-1, keepdims=True)
    on = np.array([True, False, True, True, False])
    return x, y, ref_x, t, on


def _port_state(model):
    return ([p.detach().clone() for p in model.w]
            + [p.detach().clone() for p in model.b])


def _jax_state_leaves(params):
    ws = [np.asarray(layer["w"]) for layer in params["layers"]]
    bs = [np.asarray(layer["b"]) for layer in params["layers"]]
    return ws + bs


@pytest.mark.parametrize("family", ["mlp-s", "mlp-m", "mlp-l"])
@pytest.mark.parametrize("use_ref", [False, True])
def test_cohort_step_matches_reference(family, use_ref):
    apply_fn, jparams = _jax_cohort(family, 0)
    model = _port_cohort(family, jparams)
    jopt = jax_sgd(0.05, momentum=0.9)
    jstate = jax.vmap(jopt.init)(jparams)
    opt = sgd(0.05, momentum=0.9)
    state = opt.init(list(model.parameters()))
    before = _port_state(model)
    # two steps, so the second one reads a nonzero momentum
    for step in range(2):
        x, y, ref_x, t, on = _inputs(10 + step)
        jparams, jstate, jloss = jax_cohort_step(
            apply_fn, jopt, jparams, jstate, jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(ref_x), jnp.asarray(t), jnp.asarray(on), RHO,
            use_ref)
        state, loss = cohort_step(
            model, opt, state, torch.from_numpy(x), torch.from_numpy(y),
            torch.from_numpy(ref_x), torch.from_numpy(t),
            torch.from_numpy(on), RHO, use_ref)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss),
                                   rtol=1e-5, atol=1e-6)
    after = _port_state(model)
    for got, want in zip(after, _jax_state_leaves(jparams)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    jmom = _jax_state_leaves(jstate.momentum)
    for got, want in zip(state.momentum, jmom):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(state.step.numpy(),
                                  np.asarray(jstate.step))
    # rows 1 and 4 were never trainable: bit-identical, moments zero,
    # step counter still 0
    frozen = ~_inputs(10)[4]
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a[frozen].numpy(), b[frozen].numpy())
    for m in state.momentum:
        assert float(m[frozen].abs().sum()) == 0.0
    np.testing.assert_array_equal(state.step.numpy(), np.where(frozen, 0, 2))


@pytest.mark.parametrize("family", ["mlp-s", "mlp-l"])
def test_messengers_and_accuracy_match_reference(family):
    apply_fn, jparams = _jax_cohort(family, 1)
    model = _port_cohort(family, jparams)
    rng = np.random.default_rng(2)
    ref_x = rng.normal(size=(R, L)).astype(np.float32)
    want = np.asarray(jax_cohort_messengers(apply_fn, jparams,
                                            jnp.asarray(ref_x)))
    got = cohort_messenger_upload(model, torch.from_numpy(ref_x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    payload = cohort_messenger_upload(model, torch.from_numpy(ref_x),
                                      codec="dense32")
    assert payload.shape == (N_C, R, C) and payload.rows == N_C
    xs = rng.normal(size=(N_C, 40, L)).astype(np.float32)
    ys = rng.integers(0, C, (N_C, 40)).astype(np.int32)
    mask = np.arange(40)[None, :] < rng.integers(10, 41, N_C)[:, None]
    np.testing.assert_allclose(
        cohort_accuracy(model, torch.from_numpy(xs),
                        torch.from_numpy(ys).long()).numpy(),
        np.asarray(jax_cohort_accuracy(apply_fn, jparams, jnp.asarray(xs),
                                       jnp.asarray(ys))), atol=1e-6)
    np.testing.assert_allclose(
        cohort_accuracy_masked(model, torch.from_numpy(xs),
                               torch.from_numpy(ys).long(),
                               torch.from_numpy(mask)).numpy(),
        np.asarray(jax_cohort_accuracy_masked(
            apply_fn, jparams, jnp.asarray(xs), jnp.asarray(ys),
            jnp.asarray(mask))), atol=1e-6)
    assert cohort_pred(model, torch.from_numpy(xs)).shape == (N_C, 40)


def test_cohort_batch_gathers_like_take_along_axis():
    rng = np.random.default_rng(3)
    data = {"x": rng.normal(size=(N_C, 20, L)).astype(np.float32),
            "y": rng.integers(0, C, (N_C, 20)).astype(np.int32)}
    key = jax.random.key(4)
    want = jax_cohort_batch(key, {k: jnp.asarray(v) for k, v in
                                  data.items()}, B)
    idx = np.array(jax.random.randint(key, (N_C, B), 0, 20))
    got = cohort_batch({k: torch.from_numpy(v) for k, v in data.items()},
                       torch.from_numpy(idx))
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
    np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))


@pytest.mark.parametrize("make,jax_make,kw", [
    (pad_like, jax_pad_like, dict(samples_per_client=30, ref_size=30,
                                  length=24)),
    (sc_like, jax_sc_like, dict(samples_per_client=20, ref_size=24,
                                length=16))])
def test_numpy_data_modules_reproduce_reference(make, jax_make, kw):
    ds, jds = make(**kw), jax_make(**kw)
    for name in ("ref_x", "ref_y", "client_cluster"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name))
    for a, b in zip(ds.client_x + ds.client_y, jds.client_x + jds.client_y):
        np.testing.assert_array_equal(a, b)
    splits, jsplits = make_splits(ds, seed=0), jax_make_splits(jds, seed=0)
    for s, js in zip(splits, jsplits):
        for f in ("train_x", "train_y", "val_x", "val_y", "test_x",
                  "test_y"):
            np.testing.assert_array_equal(getattr(s, f), getattr(js, f))
    packed, jpacked = pack_cohort(splits[:4]), jax_pack_cohort(jsplits[:4])
    np.testing.assert_array_equal(packed["x"], jpacked["x"])


def test_staged_join_matches_reference():
    join = [0, 0, 2, 1, 3, 2]
    for rnd in range(5):
        np.testing.assert_array_equal(
            StagedJoin(join).available(rnd, 6),
            JaxStagedJoin(join).available(rnd, 6))
