"""The port's LM training step against live runs of the reference's.

  * ``make_train_step`` (Adam on warmup-cosine, and SGD) against the
    reference's jitted step on mixtral's reduced config (GShard, fp32),
    with K = 1 and K = 2 microbatches (strided rows, fp32 accumulation)
    and a clip that binds and one that does not: the four metrics and
    the optimizer's moments tightly (1e-5 of the largest), params after
    SGD steps tightly, params after Adam steps within 2 lr of the
    reference's (Adam turns a near-zero gradient component into an update
    of about +-lr, whose sign the two packages' fp32 sums may set
    differently) and within 1e-5 lr of the update recomputed in float64
    from the port's moments and the reference's lr schedule. The second
    step resumes from the reference's params and optimizer state, carried
    across by ``convert.lm_opt_state_from_numpy``. One bf16 case per K on
    qwen2's reduced config within BF16_REL (the frameworks round bf16 at
    different points).
  * ``clip_tree_by_global_norm`` against the reference's clip on a tree
    whose leaves carry a leading layer-group axis (one norm over every
    leaf, a bf16 leaf scaled by the bf16-rounded scale).
  * with bf16 params and K = 2, the clip's norm is that of the strided
    microbatches' grads summed in fp32 (within 1e-6), which a bf16 sum
    would miss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro import optim as JO
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch import optim as TO
from repro_torch.convert import (lm_opt_state_from_numpy,
                                 lm_opt_state_to_numpy, lm_tree_from_numpy,
                                 lm_tree_to_numpy)
from repro_torch.launch import steps as TS

CPU = torch.device("cpu")
REL = 1e-5
BF16_REL = 3e-2
LR = 1e-2
_NUDGED = {"scale", "bq", "bk", "bv", "conv_b", "b_a", "b_i", "dt_bias",
           "a_log", "d_skip", "norm_scale"}


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_cache():
    jax.clear_caches()


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


def _bits(a):
    """A leaf's bits as numpy (bf16 as uint16), whichever package made
    it."""
    if isinstance(a, torch.Tensor):
        a = lm_tree_to_numpy(a)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _floats(tree):
    """Every leaf as a float64 numpy array (bf16 bits viewed as bf16)."""
    out = []
    for a in jax.tree.leaves(tree):
        a = np.asarray(a)
        if a.dtype == np.uint16:
            a = a.view(ml_dtypes.bfloat16)
        out.append(a.astype(np.float64))
    return out


# --------------------------------------------------------------------------
# make_train_step
# --------------------------------------------------------------------------

# (arch, dtype, microbatches, clip_norm, optimizer): clip 1e-3 binds
# (gnorm ~0.1-10), 1e3 does not
STEP_CASES = [("mixtral-8x7b", "fp32", 1, 1e3, "adam"),
              ("mixtral-8x7b", "fp32", 1, 1e-3, "adam"),
              ("mixtral-8x7b", "fp32", 2, 1e3, "adam"),
              ("mixtral-8x7b", "fp32", 2, 1e-3, "adam"),
              ("mixtral-8x7b", "fp32", 2, 1e-3, "sgd"),
              ("mixtral-8x7b", "fp32", 1, 1e3, "sgd"),
              ("qwen2-0.5b", "bf16", 1, 1e3, "sgd"),
              ("qwen2-0.5b", "bf16", 2, 1e-3, "sgd")]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _optimizers(name):
    if name == "adam":
        # warmup 1 of 4: the first step's lr is 0, the second's LR
        return (JO.adam(JO.warmup_cosine(LR, 1, 4)),
                TO.single_model(TO.adam(TO.warmup_cosine(LR, 1, 4))))
    return JO.sgd(LR), TO.single_model(TO.sgd(LR))


@pytest.mark.parametrize("arch,dtype,k,clip,opt", STEP_CASES)
def test_train_step_matches_reference(arch, dtype, k, clip, opt):
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(JC.get_reduced(arch), param_dtype=jdt)
    tcfg = dataclasses.replace(TC.get_reduced(arch), param_dtype=tdt)
    jopt, topt = _optimizers(opt)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(2):
        rows = rng.integers(0, jcfg.vocab_size, (4, 17)).astype(np.int32)
        batches.append({"tokens": rows[:, :-1], "labels": rows[:, 1:]})
    jstep = jax.jit(JS.make_train_step(jcfg, jopt, remat=False,
                                       clip_norm=clip, microbatches=k))
    tstep = TS.make_train_step(tcfg, topt, remat=False, clip_norm=clip,
                               microbatches=k)
    params = jax.tree.map(np.asarray, _reference_params(jcfg))
    state = jopt.init(params)
    tstate = topt.init(lm_tree_from_numpy(params, CPU))
    assert tstate.step.shape == () and tstate.step.dtype == torch.int32
    for i, b in enumerate(batches):
        # each step starts from the reference's params and state: the
        # second resumes from the reference's first step
        tparams = lm_tree_from_numpy(params, CPU)
        tstate = lm_opt_state_from_numpy(
            jax.tree.map(np.asarray, state._asdict()), type(tstate), CPU)
        new_p, new_s, m = jstep(params, state, b)
        got_p, got_s, tm = tstep(tparams, tstate,
                                 {n: torch.from_numpy(v) for n, v in
                                  b.items()})
        rel = REL if dtype == "fp32" else BF16_REL
        for name in ("loss", "ce", "moe_aux", "gnorm"):
            assert tm[name].shape == () and tm[name].dtype == torch.float32
            want = float(m[name])
            assert abs(float(tm[name]) - want) <= rel * max(abs(want),
                                                            1e-6), name
        assert (float(m["gnorm"]) > clip) == (clip < 1.0)
        assert (float(m["moe_aux"]) > 0) == (arch == "mixtral-8x7b")
        got = lm_opt_state_to_numpy(got_s)
        assert int(got["step"]) == i + 1 == int(new_s.step)
        for field in ("mu", "nu", "momentum"):
            if field in got and got[field] is not None:
                for g, w in zip(_floats(got[field]),
                                _floats(getattr(new_s, field))):
                    _close(g, w, rel, field)
        old = _floats(params)
        if opt == "adam":
            # the port's update, tightly: p plus the update recomputed in
            # float64 from the port's new moments (held to the reference's
            # above) with the reference's lr at this step and its bias
            # corrections, rounded to fp32 as the reference rounds them;
            # up to fp32 arithmetic and the rounding of p + u
            lr_t = float(JO.warmup_cosine(LR, 1, 4)(jnp.int32(i)))
            t = jnp.float32(i + 1)
            bc1, bc2 = float(1 - 0.9 ** t), float(1 - 0.999 ** t)
            for g, p, mu, nu in zip(_floats(lm_tree_to_numpy(got_p)), old,
                                    _floats(got["mu"]), _floats(got["nu"])):
                want = p - lr_t * (mu / bc1) / (np.sqrt(nu / bc2) + 1e-8)
                assert np.all(np.abs(g - want) <= REL * lr_t
                              + 2.0 ** -23 * np.abs(want)), "adam update"
        for g, w, p in zip(_floats(lm_tree_to_numpy(got_p)),
                           _floats(new_p), old):
            if opt == "sgd":
                # the update itself, tightly, but for the rounding of p + u
                # to the param dtype on each side (one spacing of p)
                eps = 2.0 ** -23 if dtype == "fp32" else 2.0 ** -7
                assert np.all(np.abs(g - w) <= rel * np.abs(w - p).max()
                              + eps * np.abs(p)), "sgd params"
            else:
                lr_t = 0.0 if i == 0 else LR
                assert np.abs(g - w).max() <= 2 * lr_t + 1e-6 * np.abs(
                    p).max()
        params, state = jax.tree.map(np.asarray, new_p), new_s


def test_single_model_clip_matches_reference():
    """One norm over every leaf of a tree whose leaves have a leading
    layer-group axis (a per-row clip would scale each group apart), the
    leaves summed in ``jax.tree.leaves`` order, a bf16 leaf scaled by the
    bf16-rounded scale."""
    rng = np.random.default_rng(9)
    tree = {"groups": {"pos1": {"w": rng.normal(size=(3, 5, 4))},
                       "pos0": {"w": 4.0 * rng.normal(size=(3, 7))}},
            "embed": rng.normal(size=(11, 4)),
            "rem": [{"w": rng.normal(size=(6,))}]}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    tree["embed"] = tree["embed"].astype(ml_dtypes.bfloat16)
    for max_norm in (0.5, 1e3):
        want, wn = JO.clip_by_global_norm(tree, max_norm)
        got, gn = TO.clip_tree_by_global_norm(lm_tree_from_numpy(tree, CPU),
                                              max_norm)
        assert gn.shape == () and abs(float(gn) - float(wn)) <= 1e-6 * float(
            wn)
        assert got["embed"].dtype == torch.bfloat16
        # fp32 leaves within the norm's rounding (another sum order); the
        # bf16 leaf bit for bit: scaled by the scale rounded to bf16
        for g, w in zip(jax.tree.leaves(lm_tree_to_numpy(got)),
                        jax.tree.leaves(want)):
            if np.asarray(w).dtype == ml_dtypes.bfloat16:
                np.testing.assert_array_equal(_bits(g), _bits(w))
            else:
                _close(g, w, 1e-6)
        scale = torch.tensor(min(1.0, max_norm / float(gn))).to(
            torch.bfloat16)
        assert torch.equal(got["embed"], lm_tree_from_numpy(
            tree, CPU)["embed"] * scale)
    # the leading axis is not a client axis: the cohort clip would give
    # each group row its own norm
    rows, norms = TO.clip_by_global_norm(
        [torch.from_numpy(tree["groups"]["pos0"]["w"])], 0.5)
    assert norms.shape == (3,)


def test_microbatch_grads_accumulate_in_fp32():
    """bf16 params, K = 2: the clip sees the two strided microbatches'
    bf16 grads summed in fp32 and halved, whose norm differs from that
    of a bf16 sum; gnorm is that fp32 norm."""
    from repro_torch.launch.steps import lm_value_and_grad
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(TC.get_reduced("qwen2-0.5b"),
                              param_dtype=torch.bfloat16)
    params = TT.init_params(cfg, CPU, torch.Generator().manual_seed(4))
    rows = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32))
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    opt = TO.single_model(TO.sgd(0.0))
    step = TS.make_train_step(cfg, opt, remat=False, clip_norm=1e3,
                              microbatches=2)
    _, _, m = step(params, opt.init(params), batch)
    g0, g1 = (lm_value_and_grad(params, cfg, {k: v[j::2] for k, v in
                                              batch.items()})[3]
              for j in range(2))
    assert g0[0].dtype == torch.bfloat16

    def norm(gs):
        return float(torch.sqrt(sum((g.double() ** 2).sum() for g in gs)))

    fp32 = norm([(a.float() + b.float()) * 0.5 for a, b in zip(g0, g1)])
    bf16 = norm([(a + b) * 0.5 for a, b in zip(g0, g1)])
    assert abs(float(m["gnorm"]) - fp32) <= 1e-6 * fp32
    assert abs(bf16 - fp32) > 1e-5 * fp32
