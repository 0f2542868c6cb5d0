"""The port's model zoo registry, assignment parsing, mixed-architecture
federations and ``federate --zoo`` against the reference's.

The federations use tests/test_torch_engine.py's fixture (pad_like(30,
30, 24), splits seed 0, batch 8, eval_every 2, seed 7, the reference on
kernel backend ``jnp``) with four families (``rglru``'s cohort step is
held in tests/test_torch_models.py) under a weighted assignment. Both packages get the same numpy-made stacked weights (the
reference through its cohorts, the port through ``init_params``) and
the reference's threefry batch draws (through ``batch_indices``).

History bookkeeping must be equal, and eval logits agree to LOGIT_TOL
(1e-4), the MLP federations' bound. The drift's source is the two
frameworks' fp32 rounding (summation orders in the convolutions, einsums
and scans), which Adam can amplify: its update is close to ±lr for any
gradient element well above eps, so an element near zero whose sign
differs between the frameworks would move its weight by up to 2·lr =
6e-3. On this fixture the worst drift measured is 9.5e-6 (sync) and
1.5e-5 (async).
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.models.zoo as JZ
import repro_torch.core as T
import repro_torch.models.zoo as TZ
from repro.data import make_splits as jax_make_splits
from repro.data import pad_like as jax_pad_like
from repro_torch.core import wire
from repro_torch.data import make_splits, pad_like
from repro_torch.launch import federate
from repro_torch.optim import AdamState, SGDState, sgd
from test_torch_async import _lazy_draws
from test_torch_engine import LOGIT_TOL, _stack_test
from test_torch_models import numpy_params

ZOO = "mlp-s,resnet,transformer,ssm"
SPEC = "mlp-s:0.4,resnet:0.3,transformer:0.2,ssm:0.1"
CFG = dict(rounds=4, batch_size=8, eval_every=2)
SEED = 7


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_cache():
    # the mixed zoo compiles large vmapped reference modules; start from
    # an empty XLA cache as tests/test_zoo.py does
    jax.clear_caches()


# --- registry and assignment -----------------------------------------------

def test_registry_equals_the_reference():
    assert TZ.registered_families() == JZ.registered_families()
    assert TZ.DEFAULT_ZOO == JZ.DEFAULT_ZOO
    for name in TZ.registered_families():
        tspec, jspec = TZ.get_family(name), JZ.get_family(name)
        assert tspec.tier == jspec.tier
        p = [torch.zeros(2, 3)]
        tstate = tspec.make_optimizer().init(p)
        jstate = jax.vmap(jspec.make_optimizer().init)([jnp.zeros((2, 3))])
        # the same kind of optimizer, with momentum where the reference's
        assert type(tstate).__name__ == type(jstate).__name__
        if isinstance(tstate, SGDState):
            assert (tstate.momentum is None) == (jstate.momentum is None)
    assert type(TZ.get_family("transformer").make_optimizer().init(
        [torch.zeros(1, 1)])) is AdamState


def test_registry_errors_and_coercion():
    with pytest.raises(ValueError, match="already registered"):
        TZ.register_family("mlp-s")(lambda i, c: None)
    with pytest.raises(KeyError) as te:
        TZ.get_family("vgg")
    with pytest.raises(KeyError) as je:
        JZ.get_family("vgg")
    assert str(te.value) == str(je.value)
    spec = TZ.get_family("ssm")
    assert TZ.as_family(spec) is spec and TZ.as_family("ssm") is spec


@pytest.mark.parametrize("names", [None, "mlp-s, resnet", ("ssm", "rglru"),
                                   "", "mlp-s,mlp-s", "mlp-s,vgg"])
def test_build_zoo_like_the_reference(names):
    try:
        want = JZ.build_zoo(names, 24, 3)
    except (KeyError, ValueError) as e:
        with pytest.raises(type(e)) as got:
            TZ.build_zoo(names, 24, 3)
        assert str(got.value) == str(e)
        return
    got = TZ.build_zoo(names, 24, 3)
    assert list(got) == list(want) and list(got.optimizers) == list(want)


ASSIGNMENTS = [
    (None, ["a", "b", "c"], 7),
    ("b,a", ["a", "b", "c"], 5),
    ("a:0.5,b:0.25,c:0.25", ["a", "b", "c"], 16),
    ("c:1,a:1", ["a", "b", "c"], 9),            # ties: first listed wins
    ("a:2,b:1,c:1", ["a", "b", "c"], 13),
    ("a:0.3,b:0.3,c:0.2,d:0.1,e:0.1", list("abcde"), 28),
    (" a : 1 , b:3 ", ["a", "b"], 6),
    (["b", "a", "b"], ["a", "b"], 3),
    # every error case
    ("a,z", ["a", "b"], 4),
    ("a:0.5,b", ["a", "b"], 4),
    ("a:lots,b:1", ["a", "b"], 4),
    ("a:0,b:1", ["a", "b"], 4),
    ("a:-1,b:1", ["a", "b"], 4),
    ("a:1,a:1", ["a", "b"], 4),
    (["a", "b"], ["a", "b"], 3),
    (["a", "z", "a"], ["a", "b"], 3),
    (",", ["a"], 2),
    ("a", [], 2),
]


@pytest.mark.parametrize("spec,names,n", ASSIGNMENTS)
def test_parse_assignment_like_the_reference(spec, names, n):
    try:
        want = JZ.parse_assignment(spec, names, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TZ.parse_assignment(spec, names, n)
        assert str(got.value) == str(e)
        return
    assert TZ.parse_assignment(spec, names, n) == want


def test_port_imports_no_jax():
    """The zoo, the optimizers and the wire import with JAX and the
    reference package blocked."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.models.zoo, repro_torch.optim, "
            "repro_torch.core.wire, repro_torch.launch.federate; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# --- mixed-architecture federations against live reference runs ----------

@pytest.fixture(scope="module")
def jax_zoo():
    """The reference's zoo with a zero init standing in for its draws
    (each cohort's params are then replaced by numpy-made ones), built
    once so both reference runs share their compiled steps."""
    ds = jax_pad_like(samples_per_client=30, ref_size=30, length=24)
    zoo = JZ.build_zoo(ZOO, ds.feature_len, ds.n_classes)
    fast = JZ.Zoo()
    fast.optimizers.update(zoo.optimizers)
    inits = {}
    for name, (init_fn, apply_fn) in zoo.items():
        shapes = jax.eval_shape(init_fn, jax.random.key(0))
        inits[name] = init_fn
        fast[name] = (jax.jit(lambda key, s=shapes: jax.tree.map(
            lambda a: jnp.zeros(a.shape, a.dtype), s)), apply_fn)
    return fast, inits


def _logit_recorder(splits, n, n_classes, out, port):
    fns = {}

    def cb(engine, rnd, metrics):
        got = np.zeros((n, len(splits[0].test_y), n_classes))
        for coh in engine.fed.cohorts:
            xs, _ = _stack_test(splits, coh.client_ids)
            if port:
                with torch.no_grad():
                    got[coh.client_ids] = coh.model(
                        torch.from_numpy(xs)).numpy()
            else:
                fn = fns.setdefault(coh.family_name,
                                    jax.jit(jax.vmap(coh.apply_fn)))
                got[coh.client_ids] = np.asarray(fn(coh.params,
                                                    jnp.asarray(xs)))
        out.append(got)
    return cb


def _run_both(jax_zoo, asynchronous: bool):
    fast, inits = jax_zoo
    ds = jax_pad_like(samples_per_client=30, ref_size=30, length=24)
    splits = jax_make_splits(ds, seed=0)
    jlogits, tlogits = [], []
    jcb = _logit_recorder(splits, ds.n_clients, ds.n_classes, jlogits,
                          port=False)
    jcfg = J.FederationConfig(**CFG, backend="jnp")
    if asynchronous:
        jeng = J.AsyncFederationEngine.build(
            ds, splits, fast, SPEC, J.sqmd(q=8, k=4),
            arrivals=J.StragglerLatency(fraction=0.3, delay=2.5, seed=1),
            trigger=J.Quorum(frac=0.5), config=jcfg, seed=SEED,
            callbacks=[jcb])
    else:
        jeng = J.FederationEngine.build(ds, splits, fast, SPEC,
                                        J.sqmd(q=8, k=4), config=jcfg,
                                        seed=SEED, callbacks=[jcb])
    init_params = {}
    for i, coh in enumerate(jeng.fed.cohorts):
        params = numpy_params(inits[coh.family_name], coh.n_clients, 20 + i)
        init_params[coh.family_name] = params
        coh.params = jax.tree.map(jnp.asarray, params)
        coh.opt_state = jax.jit(jax.vmap(coh.optimizer.init))(coh.params)
    draws = _lazy_draws(jeng, CFG["batch_size"])

    pds = pad_like(samples_per_client=30, ref_size=30, length=24)
    psplits = make_splits(pds, seed=0)
    tcb = _logit_recorder(psplits, pds.n_clients, pds.n_classes, tlogits,
                          port=True)
    common = dict(config=T.FederationConfig(**CFG), seed=SEED,
                  callbacks=[tcb], device="cpu", init_params=init_params,
                  batch_indices=draws)
    tzoo = TZ.build_zoo(ZOO, pds.feature_len, pds.n_classes)
    if asynchronous:
        teng = T.AsyncFederationEngine.build(
            pds, psplits, tzoo, SPEC, T.sqmd(q=8, k=4),
            arrivals=T.StragglerLatency(fraction=0.3, delay=2.5, seed=1),
            trigger=T.Quorum(frac=0.5), **common)
        jhist, thist = jeng.fit(splits, until=4.0), teng.fit(psplits,
                                                             until=4.0)
    else:
        teng = T.FederationEngine.build(pds, psplits, tzoo, SPEC,
                                        T.sqmd(q=8, k=4), **common)
        jhist, thist = jeng.fit(splits), teng.fit(psplits)
    return dict(jeng=jeng, teng=teng, jhist=jhist, thist=thist,
                jlogits=jlogits, tlogits=tlogits)


@pytest.fixture(scope="module", params=["sync", "async"])
def runs(request, jax_zoo):
    return _run_both(jax_zoo, request.param == "async")


def test_mixed_federation_builds_the_reference_cohorts(runs):
    jc, tc = runs["jeng"].fed.cohorts, runs["teng"].fed.cohorts
    assert [c.family_name for c in tc] == [c.family_name for c in jc] \
        == ZOO.split(",")
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.client_ids, b.client_ids)
        assert type(a.opt_state).__name__ == type(b.opt_state).__name__
        assert a.optimizer is not None


def test_mixed_federation_history_matches(runs):
    jh, th = runs["jhist"], runs["thist"]
    assert th.rounds == jh.rounds and th.times == jh.times
    assert th.server_rounds == jh.server_rounds
    assert th.staleness == jh.staleness
    assert th.bytes_up == jh.bytes_up and th.bytes_down == jh.bytes_down
    assert len(th.mean_acc) == len(jh.mean_acc) >= 2


def test_mixed_federation_eval_logits_match(runs):
    assert len(runs["tlogits"]) == len(runs["jlogits"]) \
        == len(runs["jhist"].rounds)
    for t, j in zip(runs["tlogits"], runs["jlogits"]):
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, rtol=0)


def test_mixed_federation_state_matches(runs):
    """Adam's step counters equal the reference's, client for client, and
    the repositories agree to the logit bound."""
    for a, b in zip(runs["teng"].fed.cohorts, runs["jeng"].fed.cohorts):
        np.testing.assert_array_equal(a.opt_state.step.numpy(),
                                      np.asarray(b.opt_state.step))
    js, ts = runs["jeng"].server, runs["teng"].server
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    np.testing.assert_allclose(ts.repo_logp.numpy(), np.asarray(js.repo_logp),
                               atol=LOGIT_TOL, rtol=0)


def test_explicit_optimizer_overrides_family_defaults():
    """``optimizer=`` wins over every family's default: each cohort,
    Adam families included, carries the explicit momentum-less SGD."""
    ds = pad_like(samples_per_client=12, ref_size=9, length=16)
    splits = make_splits(ds, seed=0)
    opt = sgd(0.01)
    zoo = TZ.build_zoo("mlp-s,transformer,ssm", ds.feature_len,
                       ds.n_classes)
    eng = T.FederationEngine.build(
        ds, splits, zoo, None, T.sqmd(q=4, k=2),
        config=T.FederationConfig(rounds=1, batch_size=4), seed=3,
        device="cpu", optimizer=opt)
    for coh in eng.fed.cohorts:
        assert coh.optimizer is opt
        assert type(coh.opt_state) is SGDState
        assert coh.opt_state.momentum is None
    assert np.isfinite(eng.fit(splits).mean_acc).all()
    # without it the zoo's defaults ride along, as in the reference
    eng = T.FederationEngine.build(
        ds, splits, zoo, None, T.sqmd(q=4, k=2), seed=3, device="cpu")
    assert [type(c.opt_state) for c in eng.fed.cohorts] \
        == [SGDState, AdamState, AdamState]


def test_wire_traffic_is_architecture_blind():
    """Same codec, same (N, R, C) payload geometry, same bytes per
    messenger and normalized log-prob rows, whether the cohorts are
    MLP-only or a four-family mix."""
    ds = pad_like(samples_per_client=12, ref_size=9, length=16)
    splits = make_splits(ds, seed=0)
    on = np.ones(ds.n_clients, bool)
    engines = [T.FederationEngine.build(
        ds, splits, TZ.build_zoo(zoo, ds.feature_len, ds.n_classes), spec,
        T.sqmd(q=4, k=2), seed=3, device="cpu")
        for zoo, spec in ((ZOO, SPEC), (None, None))]
    mixed, mlp = (e.clients.collect_messengers(on) for e in engines)
    r = int(engines[0].fed.ref_x.shape[0])
    assert mixed.codec == mlp.codec
    assert mixed.shape == mlp.shape == (ds.n_clients, r, ds.n_classes)
    assert wire.bytes_per_messenger(mixed) == wire.bytes_per_messenger(mlp)
    np.testing.assert_allclose(
        torch.logsumexp(wire.decode(mixed), -1).numpy(), 0.0, atol=1e-5)


# --- the launch CLI ---------------------------------------------------------

CLI = ["--rounds", "1", "--batch", "4", "--eval-every", "1",
       "--samples-per-client", "12", "--ref-size", "9",
       "--zoo", "mlp-s,mlp-m", "--assignment", "mlp-m:0.75,mlp-s:0.25"]


def test_federate_cli_zoo_summary_matches_reference(monkeypatch, capsys):
    from repro.launch import federate as jfederate
    monkeypatch.setattr("sys.argv", ["federate", *CLI, "--backend", "jnp"])
    jfederate.main()
    out = capsys.readouterr().out
    want = json.loads(out[out.index("{"):])
    got = federate.main(["--device", "cpu", *CLI])
    for key in ("zoo", "assignment", "rounds", "server_rounds",
                "virtual_time", "staleness", "bytes_up", "bytes_down",
                "uplink", "downlink"):
        assert got[key] == want[key], key
    assert np.isfinite(got["final_acc"])


def test_federate_cli_rejects_bad_zoo_and_assignment(capsys):
    for bad in (["--zoo", "mlp-s,vgg"],
                ["--zoo", "mlp-s,ssm", "--assignment", "ssm:1,rglru:1"],
                ["--assignment", "mlp-s:0"]):
        with pytest.raises(SystemExit):
            federate.main(["--device", "cpu", "--rounds", "1", *bad])
    err = capsys.readouterr().err
    assert "registered" in err and "not in the zoo" in err \
        and "must be > 0" in err
