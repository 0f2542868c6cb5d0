"""The port's zoo families against the reference's ``repro.models``.

Every registered family, and the paper's RESNET8/20/50, is built in both
packages at n_c = 3 clients with the same numpy-made stacked params (in
the reference's layout, carried into the port by ``repro_torch.convert``)
and the same numpy-seeded inputs. Logits agree to 2e-6 relative to the
largest logit; gradients of a fixed linear read-out of the logits to 1e-5
relative to the largest gradient of the leaf (the frameworks sum
convolutions, einsums and the scans in another order; the RG-LRU
recurrence is a loop here and a tree in the reference). One cohort step
with the family's default optimizer matches the reference's loss to 1e-5
relative and its params to 1e-5 absolute.

The traps named in each module are pinned here: XLA's asymmetric "SAME"
padding at stride 2, the biased GroupNorm variance, ``_segsum``'s exact
zeros, softplus at large inputs and the tanh gelu.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.client import cohort_step as jax_cohort_step
from repro.models import resnet as jresnet
from repro.models import ssm as jssm
from repro.models import zoo as jzoo
from repro_torch.convert import family_params_from_numpy, load_cohort_params
from repro_torch.core.client import cohort_step
from repro_torch.models import resnet, ssm, zoo
from repro_torch.models.common import StackedCohort

N_C, B, L, C, R = 3, 5, 24, 3, 6
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_cache():
    # many vmapped reference modules compile here; start from an empty
    # XLA cache as tests/test_zoo.py does
    jax.clear_caches()


def _families():
    out = {f: (lambda f=f: (jzoo.build_zoo(f, L, C)[f],
                            zoo.build_zoo(f, L, C)[f]))
           for f in jzoo.registered_families()}
    for jc, tc in ((jresnet.RESNET8, resnet.RESNET8),
                   (jresnet.RESNET20, resnet.RESNET20),
                   (jresnet.RESNET50, resnet.RESNET50)):
        out[tc.name] = (lambda jc=jc, tc=tc: (jresnet.resnet1d_family(jc),
                                              resnet.resnet1d_family(tc)))
    return out


FAMILIES = _families()


def numpy_params(init_fn, n_c, seed):
    """Stacked params of ``init_fn``'s structure made with numpy: weights
    N(0, 1/fan_in) (fan_in: all but the last axis), vectors 1 + N(0, 0.1)
    (norm scales, biases, decay rates all stay in a sane range)."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if len(s.shape) >= 2:
            fan = int(np.prod(s.shape[:-1]))
            w = rng.normal(size=(n_c, *s.shape)) / np.sqrt(fan)
        else:
            w = 1.0 + 0.1 * rng.normal(size=(n_c, *s.shape))
        return w.astype(np.float32)

    return jax.tree.map(leaf, jax.eval_shape(init_fn, jax.random.key(0)))


def _pair(name, seed=1):
    (init_fn, apply_fn), build = FAMILIES[name]()
    params = numpy_params(init_fn, N_C, seed)
    jparams = jax.tree.map(jnp.asarray, params)
    model = build(N_C, device=CPU)
    load_cohort_params(model, params)
    return apply_fn, jparams, model


def _grad_leaves(model, jgrads):
    """The reference's grads in the port's layout, in parameter order."""
    jg = jax.tree.map(np.asarray, jgrads)
    if isinstance(model, StackedCohort):
        flat = family_params_from_numpy(model.family, jg)
        return [flat[k].numpy() for k in model.params]
    layers = jg["layers"]
    return [layer["w"] for layer in layers] + [layer["b"] for layer in layers]


def _close_rel(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_and_grad_match_reference(name):
    apply_fn, jparams, model = _pair(name)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N_C, B, L)).astype(np.float32)
    w = rng.normal(size=(N_C, B, C)).astype(np.float32)
    logits = model(torch.from_numpy(x))
    assert logits.shape == (N_C, B, C)

    def readout(p, xx, ww):
        out = apply_fn(p, xx)
        return jnp.sum(out * ww), out

    (_, want), jgrads = jax.jit(jax.vmap(jax.value_and_grad(
        readout, has_aux=True)))(jparams, jnp.asarray(x), jnp.asarray(w))
    _close_rel(logits.detach().numpy(), np.asarray(want), 2e-6)
    grads = torch.autograd.grad((logits * torch.from_numpy(w)).sum(),
                                list(model.parameters()))
    want_g = _grad_leaves(model, jgrads)
    assert len(grads) == len(want_g)
    for got, want in zip(grads, want_g):
        assert tuple(got.shape) == want.shape
        _close_rel(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("name", ["resnet", "transformer", "ssm", "rglru"])
def test_cohort_step_with_family_optimizer_matches_reference(name):
    """One SQMD step of the cohort with the family's default optimizer
    (Adam for the sequence families, SGD with momentum for the ResNet),
    client 1 frozen. tests/test_torch_client.py holds the MLP tiers'."""
    apply_fn, jparams, model = _pair(name, seed=2)
    jopt = jzoo.get_family(name).make_optimizer()
    topt = zoo.get_family(name).make_optimizer()
    jstate = jax.jit(jax.vmap(jopt.init))(jparams)
    tstate = topt.init(list(model.parameters()))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(N_C, B, L)).astype(np.float32)
    y = rng.integers(0, C, (N_C, B)).astype(np.int32)
    ref_x = rng.normal(size=(R, L)).astype(np.float32)
    t = rng.random((N_C, R, C)).astype(np.float32)
    t /= t.sum(-1, keepdims=True)
    on = np.array([True, False, True])
    jparams2, jstate2, jloss = jax_cohort_step(
        apply_fn, jopt, jparams, jstate, jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(ref_x), jnp.asarray(t), jnp.asarray(on), 0.8, True)
    before = [p.detach().clone() for p in model.parameters()]
    tstate2, loss = cohort_step(
        model, topt, tstate, torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(ref_x), torch.from_numpy(t), torch.from_numpy(on),
        0.8, True)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5,
                               atol=1e-6)
    for got, want, old in zip(model.parameters(),
                              _grad_leaves(model, jparams2), before):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5)
        assert torch.equal(got.detach()[1], old[1])
    np.testing.assert_array_equal(tstate2.step.numpy(),
                                  np.asarray(jstate2.step))
    assert type(tstate2).__name__ == type(jstate2).__name__


@pytest.mark.parametrize("length", [7, 8, 63, 64])
@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (1, 2), (5, 2)])
def test_same_padding_matches_xla(length, kernel, stride):
    rng = np.random.default_rng(length + kernel)
    x = rng.normal(size=(2, length, 4)).astype(np.float32)
    w = rng.normal(size=(kernel, 4, 6)).astype(np.float32)   # HIO
    want = np.asarray(jresnet._conv1d(jnp.asarray(w), jnp.asarray(x),
                                      stride))
    got = resnet._conv1d(torch.from_numpy(w).permute(2, 1, 0).contiguous(),
                         torch.from_numpy(x).transpose(1, 2), stride)
    assert got.shape == (2, 6, -(-length // stride))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, rtol=0,
                               atol=1e-5)


def test_same_padding_is_asymmetric_at_stride_two():
    assert resnet.same_pads(64, 3, 2) == (0, 1)
    assert resnet.same_pads(63, 3, 2) == (1, 1)
    assert resnet.same_pads(64, 3, 1) == (1, 1)
    x = torch.arange(64, dtype=torch.float32).reshape(1, 1, 64)
    w = torch.tensor([[[1.0, 2.0, 3.0]]])
    # symmetric padding gives the same length and other values
    assert not torch.equal(resnet._conv1d(w, x, 2),
                           F.conv1d(x, w, stride=2, padding=1))


def test_groupnorm_uses_the_biased_variance():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 10, 5)).astype(np.float32)       # (B, L, C)
    s = rng.normal(size=5).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    want = np.asarray(jresnet._norm(jnp.asarray(s), jnp.asarray(b),
                                    jnp.asarray(x)))
    got = resnet._norm(torch.from_numpy(s), torch.from_numpy(b),
                       torch.from_numpy(x).transpose(1, 2))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, rtol=0,
                               atol=1e-5)


def test_segsum_gives_exact_zeros_above_the_diagonal():
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 6))
                         .astype(np.float32))
    got = ssm._segsum(x)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jssm._segsum(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    upper = torch.triu(torch.ones(6, 6, dtype=torch.bool), diagonal=1)
    assert torch.exp(got)[:, upper].eq(0).all()
    assert torch.isinf(got[:, upper]).all()


def test_softplus_matches_jax_at_large_inputs():
    """torch returns x itself above its threshold of 20; JAX's
    logaddexp(x, 0) rounds to the same fp32 value there."""
    x = np.array([-30, -5, 0, 5, 15, 19.99, 20, 20.01, 25, 40, 88],
                 np.float32)
    np.testing.assert_allclose(F.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-7,
                               atol=0)
    big = x >= 20
    np.testing.assert_array_equal(
        np.asarray(jax.nn.softplus(x))[big], x[big])


def test_rglru_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(x))
    np.testing.assert_allclose(
        F.gelu(torch.from_numpy(x), approximate="tanh").numpy(), want,
        rtol=0, atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4


def test_common_helpers_match_reference():
    """RoPE (the half-split rotation), rmsnorm and the causal mask."""
    from repro.models import common as jcommon
    from repro_torch.models import common
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 7, 3, 8)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + 3
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          1e4).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      1e4)), rtol=0, atol=1e-5)
    scale = rng.normal(size=8).astype(np.float32)
    np.testing.assert_allclose(
        common.rmsnorm({"scale": torch.from_numpy(scale)},
                       torch.from_numpy(x), 1e-6).numpy(),
        np.asarray(jcommon.rmsnorm({"scale": jnp.asarray(scale)},
                                   jnp.asarray(x), 1e-6)), rtol=1e-6,
        atol=1e-6)
    q, k = np.arange(5), np.arange(7) - 2
    for window in (0, 3):
        np.testing.assert_array_equal(
            common.causal_mask(torch.from_numpy(q), torch.from_numpy(k),
                               window).numpy(),
            np.asarray(jcommon.causal_mask(jnp.asarray(q), jnp.asarray(k),
                                           window)))


def test_load_params_checks_names_and_shapes():
    model = zoo.build_zoo("ssm", L, C)["ssm"](N_C, device=CPU)
    good = {k: torch.zeros_like(v) for k, v in model.params.items()}
    model.load_params(good)
    assert all(not p.detach().any() for p in model.parameters())
    with pytest.raises(ValueError, match="do not match"):
        model.load_params({k: v for k, v in good.items()
                           if k != "mixer/w_in"})
    bad = dict(good, **{"mixer/w_in": torch.zeros(N_C, 2, 2)})
    with pytest.raises(ValueError, match="has shape"):
        model.load_params(bad)
    with pytest.raises(TypeError, match="no conversion"):
        load_cohort_params(torch.nn.Linear(2, 2), {})
