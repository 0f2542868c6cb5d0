"""The port's checkpoints against the reference's ``repro.checkpoint``:
the pure-Python msgpack subset byte for byte against ``msgpack``, files
that each package reads from the other, and resumes.

The federation is tests/test_torch_async.py's (``build_both``: the port
built with the reference's initial params and threefry batch draws), on
the synchronous engine. A port run saved and restored must continue
exactly as the uninterrupted port run; a port run resumed from the
reference's file must track the reference's continued run within
LOGIT_TOL, which needs the seam's inner step taken from the file.
"""
import jax
import msgpack
import numpy as np
import pytest
import torch

import repro.checkpoint.io as JIO
import repro.core as J
import repro.models.zoo as JZ
import repro_torch.core as T
import repro_torch.models.zoo as TZ
from repro.data import make_splits as jax_make_splits
from repro.data import pad_like as jax_pad_like
from repro.models.mlp import hetero_mlp_zoo as jax_mlp_zoo
from repro_torch.checkpoint import (ZooMismatchError, latest_step,
                                    restore_federation, restore_pytree,
                                    save_federation, save_pytree)
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import io as TIO
from repro_torch.convert import cohort_params_to_numpy, opt_state_to_numpy
from repro_torch.data import make_splits, pad_like
from repro_torch.kernels import ops
from repro_torch.launch import federate
from repro_torch.models import hetero_mlp_zoo
from repro_torch.optim import AdamState, SGDState
from test_torch_async import CFG, SEED, _sqmd, build_both
from test_torch_engine import LOGIT_TOL, _stack_test

# --- the msgpack subset ------------------------------------------------------

DTYPES = [torch.float32, torch.float64, torch.float16, torch.int8,
          torch.int16, torch.int32, torch.int64, torch.uint8, torch.bool]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_msgpack_bytes_equal_packb_for_every_dtype(dtype):
    """A tree of tensors of ``dtype`` (0-d, empty, small, and one whose
    bytes need bin32) packs to ``msgpack.packb``'s bytes of the reference's
    encoding of the same numpy tree, and reads back as the same tree."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(), (0, 3), (3, 5), (70_000,)]
    ts = [(torch.randn(s, generator=gen) * 50).to(dtype) for s in shapes]
    tree = {"arrays": ts, "nested": {"b": (ts[2], None), "a": [ts[0]]}}
    want_tree = jax.tree.map(lambda x: x, {
        "arrays": [t.numpy() for t in ts],
        "nested": {"b": (ts[2].numpy(), None), "a": [ts[0].numpy()]}})
    want = msgpack.packb(JIO._encode(want_tree), use_bin_type=True)
    got = _msgpack.packb(TIO._encode(tree))
    assert got == want
    back = TIO._decode(_msgpack.unpackb(want))
    for a, b in zip(back["arrays"], ts):
        assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())
    assert isinstance(back["nested"]["b"], tuple)


def _plain(x):
    if isinstance(x, memoryview):
        return bytes(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def test_msgpack_every_scalar_and_size_class():
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
            2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
            -2**31 - 1, -2**63]
    tree = {"ints": ints, "floats": [0.0, -1.5, 1e300, float("inf"),
                                     np.float64(2.5)],
            "none": None, "bools": [True, False], "tuple": (1, (2,)),
            "strs": ["", "a" * 31, "a" * 32, "é" * 20, "x" * 256,
                     "y" * 65536],
            "bins": [b"", b"a" * 255, b"a" * 256, b"b" * 65536],
            "arrays": [list(range(15)), list(range(16)),
                       list(range(70_000))],
            "maps": [{str(i): i for i in range(n)} for n in (15, 16, 70_000)]}
    want = msgpack.packb(tree, use_bin_type=True)
    assert _msgpack.packb(tree) == want
    assert _plain(_msgpack.unpackb(want)) == _plain(
        msgpack.unpackb(want, raw=False))
    # what the reference never writes still reads: float32, str8 keys
    for other in (msgpack.packb([1.5, "k"], use_single_float=True),
                  msgpack.packb({"x" * 40: b"v"}, use_bin_type=True)):
        assert _plain(_msgpack.unpackb(other)) == _plain(
            msgpack.unpackb(other, raw=False))
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(want + b"\xc0")
    with pytest.raises(TypeError):
        _msgpack.packb({"x": object()})


def test_save_pytree_writes_the_reference_file(tmp_path):
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    tree = {"z": [t, (t[0], 3)], "a": {"b": t > 4, "s": "x"}, "n": None}
    save_pytree(str(tmp_path / "port" / "step_3.msgpack"), tree)
    JIO.save_pytree(str(tmp_path / "ref" / "step_3.msgpack"),
                    jax.tree.map(lambda x: x.numpy()
                                 if isinstance(x, torch.Tensor) else x,
                                 tree))
    port = (tmp_path / "port" / "step_3.msgpack").read_bytes()
    assert port == (tmp_path / "ref" / "step_3.msgpack").read_bytes()
    got = restore_pytree(str(tmp_path / "port" / "step_3.msgpack"))
    np.testing.assert_array_equal(got["z"][0], t.numpy())
    assert got["z"][1][1] == 3 and isinstance(got["z"][1], tuple)
    assert latest_step(str(tmp_path / "port")) == 3
    assert latest_step(str(tmp_path / "none")) is None


# --- files across the two packages ----------------------------------------

def _alwayson(m):
    return m.AlwaysOn()


def _logits(eng, splits, forward):
    """(N, M, C) test-shard logits, each cohort through ``forward``."""
    parts = {}
    for coh in eng.fed.cohorts:
        xs, _ = _stack_test(splits, coh.client_ids)
        for cid, lg in zip(coh.client_ids, forward(coh, xs)):
            parts[int(cid)] = lg
    return np.stack([parts[i] for i in range(eng.n_clients)])


def _port_logits(eng, splits):
    def forward(coh, xs):
        with torch.no_grad():
            return coh.model(torch.from_numpy(xs)).numpy()
    return _logits(eng, splits, forward)


def _ref_logits(eng, splits):
    return _logits(eng, splits, lambda coh, xs: np.asarray(
        jax.vmap(coh.apply_fn)(coh.params, xs)))


def _port_engine(r, seed, seam=True, **kw):
    """A port sync engine on build_both's data, with its seams or not."""
    pds = pad_like(samples_per_client=30, ref_size=30, length=24)
    extra = dict(init_params=r["init_params"], batch_indices=r["draws"]) \
        if seam else {}
    return T.FederationEngine.build(
        pds, r["psplits"], hetero_mlp_zoo(pds.feature_len, pds.n_classes),
        None, T.sqmd(q=8, k=4), config=T.FederationConfig(**CFG),
        seed=seed, device="cpu", **{**extra, **kw})


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """The reference runs 2 rounds and saves; the port restores that file
    into its seamed engine; both continue 2 rounds. A port run of 2 rounds
    is saved and restored into a fresh reference engine."""
    tmp = tmp_path_factory.mktemp("crossed")
    r = build_both(_sqmd, schedule=_alwayson, uplink="int8",
                   downlink="dense16")
    jeng, teng = r["jeng"], r["teng"]
    fresh = tmp / "fresh"
    JIO.save_federation(str(fresh / "ref"), jeng.fed, step=0, bus=jeng.bus)
    save_federation(str(fresh / "port"), teng.fed, step=0, bus=teng.bus,
                    clients=teng.clients)
    for rnd in range(2):
        jeng.run_round(rnd)
    JIO.save_federation(str(tmp / "ref"), jeng.fed, step=2, bus=jeng.bus)
    # a port engine from other weights and another generator takes it
    restore_federation(str(tmp / "ref"), teng.fed, bus=teng.bus,
                       clients=teng.clients)
    at_restore = dict(jlogits=_ref_logits(jeng, r["splits"]),
                      tlogits=_port_logits(teng, r["psplits"]),
                      step=teng.clients.step)
    for rnd in range(2, 4):
        jeng.run_round(rnd)
        teng.run_round(rnd)

    port = _port_engine(r, SEED)
    for rnd in range(2):
        port.run_round(rnd)
    save_federation(str(tmp / "port"), port.fed, step=2, bus=port.bus,
                    clients=port.clients)
    ref = J.FederationEngine.build(
        jax_pad_like(samples_per_client=30, ref_size=30, length=24),
        r["splits"], jax_mlp_zoo(24, 2), None, J.sqmd(q=8, k=4),
        config=J.FederationConfig(**CFG, backend="jnp"), seed=99)
    jstep = JIO.restore_federation(str(tmp / "port"), ref.fed, bus=ref.bus)
    return dict(r, tmp=tmp, fresh=fresh, at_restore=at_restore, port=port,
                ref=ref, jstep=jstep)


def _same_tree(a, b, path=""):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray)), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_fresh_federation_file_matches_the_reference_leaf_for_leaf(crossed):
    """The same federation, freshly built, saves the same tree in both
    packages, but for the reference's threefry key and the port's own
    generator state."""
    fresh = crossed["fresh"]
    ref = restore_pytree(str(fresh / "ref" / "step_0.msgpack"))
    port = restore_pytree(str(fresh / "port" / "step_0.msgpack"))
    assert "rng" in ref and "rng" not in port and "torch" in port
    del ref["rng"], port["torch"]
    _same_tree(port, ref)
    assert port["cohorts"][0]["opt_state"]["__nt__"] == "SGDState"


def test_reference_file_restores_into_the_port(crossed):
    at = crossed["at_restore"]
    np.testing.assert_allclose(at["tlogits"], at["jlogits"], atol=LOGIT_TOL,
                               rtol=0)
    jb, tb = crossed["jeng"].bus, crossed["teng"].bus
    assert tb.n_triggers == jb.n_triggers and tb.n_uploads == jb.n_uploads
    np.testing.assert_array_equal(tb.bytes_up, jb.bytes_up)
    np.testing.assert_array_equal(tb.bytes_down, jb.bytes_down)
    fed = crossed["teng"].fed
    assert (fed.uplink, fed.downlink) == ("int8", "dense16")
    # a reference file carries no inner-step count: round * local_steps
    assert at["step"] == 2


def test_port_resumed_from_the_reference_tracks_its_continued_run(crossed):
    jeng, teng = crossed["jeng"], crossed["teng"]
    np.testing.assert_allclose(_port_logits(teng, crossed["psplits"]),
                               _ref_logits(jeng, crossed["splits"]),
                               atol=LOGIT_TOL, rtol=0)
    # int8 uplink: messengers within LOGIT_TOL may round to neighboring
    # codes, one step of the row's scale apart
    jr = np.asarray(jeng.fed.server.repo_logp)
    tol = LOGIT_TOL + (jr.max(-1, keepdims=True)
                       - jr.min(-1, keepdims=True)) / 255
    assert (np.abs(teng.fed.server.repo_logp.numpy() - jr) <= tol).all()
    assert teng.bus.n_triggers == jeng.bus.n_triggers == 4
    assert teng.clients.step == 4


def test_port_file_restores_into_the_reference(crossed):
    port, ref = crossed["port"], crossed["ref"]
    assert crossed["jstep"] == 2
    np.testing.assert_allclose(_ref_logits(ref, crossed["splits"]),
                               _port_logits(port, crossed["psplits"]),
                               atol=LOGIT_TOL, rtol=0)
    assert ref.bus.n_triggers == port.bus.n_triggers == 2
    np.testing.assert_array_equal(ref.bus.bytes_up, port.bus.bytes_up)
    np.testing.assert_array_equal(ref.bus.last_upload_t,
                                  port.bus.last_upload_t)
    assert (ref.fed.uplink, ref.fed.downlink) == ("dense32", "dense32")
    for jc, tc in zip(ref.fed.cohorts, port.fed.cohorts):
        assert isinstance(jc.opt_state, type(jc.optimizer.init(
            jax.tree.map(lambda a: a[0], jc.params))))
        np.testing.assert_array_equal(np.asarray(jc.opt_state.step),
                                      tc.opt_state.step.numpy())
    np.testing.assert_array_equal(np.asarray(ref.fed.targets),
                                  port.fed.targets.numpy())


@pytest.mark.parametrize("seam", [True, False], ids=["seam", "generator"])
def test_port_resume_equals_the_uninterrupted_run(crossed, tmp_path, seam):
    """Saved at round 2 and restored into an engine of other weights and
    another seed, the run continues bit for bit: the seam's step (with
    the seams) or the generator's state (without) comes back."""
    oracle = _port_engine(crossed, 11, seam)
    first = _port_engine(crossed, 11, seam)
    for rnd in range(4):
        oracle.run_round(rnd)
    for rnd in range(2):
        first.run_round(rnd)
    save_federation(str(tmp_path), first.fed, step=2, bus=first.bus,
                    clients=first.clients)
    resumed = _port_engine(crossed, 77, seam=False)
    if seam:
        resumed.clients.batch_indices = crossed["draws"]
    assert restore_federation(str(tmp_path), resumed.fed, bus=resumed.bus,
                              clients=resumed.clients) == 2
    for rnd in range(2, 4):
        resumed.run_round(rnd)
    for a, b in zip(oracle.fed.cohorts, resumed.fed.cohorts):
        for p, q in zip(a.model.parameters(), b.model.parameters()):
            assert torch.equal(p, q)
        for p, q in zip(a.opt_state.momentum, b.opt_state.momentum):
            assert torch.equal(p, q)
    for f in ("repo_logp", "weights", "div_cache", "quality"):
        assert torch.equal(getattr(oracle.server, f),
                           getattr(resumed.server, f)), f
    assert torch.equal(oracle.fed.targets, resumed.fed.targets)
    assert resumed.bus.n_triggers == oracle.bus.n_triggers
    np.testing.assert_array_equal(resumed.bus.bytes_up, oracle.bus.bytes_up)
    assert resumed.clients.step == oracle.clients.step == 4


def test_legacy_file_without_div_cache_rebuilds_it(crossed, tmp_path):
    tree = JIO.restore_pytree(str(crossed["tmp"] / "ref" / "step_2.msgpack"))
    saved = np.asarray(tree["server"].pop("div_cache"))
    del tree["bus"]
    JIO.save_pytree(str(tmp_path / "step_2.msgpack"), tree)
    eng = _port_engine(crossed, 5, seam=False)
    restore_federation(str(tmp_path), eng.fed)
    assert torch.equal(eng.server.div_cache,
                       ops.pairwise_kl(eng.server.repo_logp))
    np.testing.assert_allclose(eng.server.div_cache.numpy(), saved,
                               atol=1e-5, rtol=1e-5)
    # a file without a bus section zeroes the given bus's counters
    eng.bus.n_triggers = 9
    restore_federation(str(tmp_path), eng.fed, bus=eng.bus)
    assert eng.bus.n_triggers == 0


# --- mixed zoo: ResNet and Adam cohorts, and the zoo check ----------------

ZOO = "mlp-s,resnet,transformer,ssm"
SPEC = "mlp-s:0.4,resnet:0.3,transformer:0.2,ssm:0.1"


def _mixed(seed, zoo=ZOO, spec=SPEC):
    ds = pad_like(samples_per_client=12, ref_size=12, length=24)
    splits = make_splits(ds, seed=0)
    eng = T.FederationEngine.build(
        ds, splits, TZ.build_zoo(zoo, ds.feature_len, ds.n_classes), spec,
        T.sqmd(q=8, k=4), config=T.FederationConfig(rounds=1, batch_size=4),
        seed=seed, device="cpu")
    return eng, splits


def _state_of(eng):
    return [(cohort_params_to_numpy(c.model),
             opt_state_to_numpy(c.model, c.opt_state))
            for c in eng.fed.cohorts]


def test_resnet_and_adam_cohorts_round_trip(tmp_path):
    """Port -> port exactly; port -> reference -> port exactly, the
    reference's params equal to the port's in the reference's layout (the
    ResNet's convolutions HIO) and its optimizer states of its types."""
    eng, splits = _mixed(1)
    eng.run_round(0)
    eng.run_round(1)
    save_federation(str(tmp_path / "a"), eng.fed, step=2, bus=eng.bus)
    fresh, _ = _mixed(2)
    restore_federation(str(tmp_path / "a"), fresh.fed, bus=fresh.bus)
    assert [type(c.opt_state) for c in fresh.fed.cohorts] == \
        [SGDState, SGDState, AdamState, AdamState]
    want = _state_of(eng)
    jax.tree.map(np.testing.assert_array_equal, _state_of(fresh), want)

    ds = jax_pad_like(samples_per_client=12, ref_size=12, length=24)
    jsplits = jax_make_splits(ds, seed=0)
    zoo = JZ.build_zoo(ZOO, ds.feature_len, ds.n_classes)
    fast = JZ.Zoo()
    fast.optimizers.update(zoo.optimizers)
    for name, (init_fn, apply_fn) in zoo.items():
        shapes = jax.eval_shape(init_fn, jax.random.key(0))
        fast[name] = (lambda key, s=shapes: jax.tree.map(
            lambda a: np.zeros(a.shape, a.dtype), s), apply_fn)
    ref = J.FederationEngine.build(
        ds, jsplits, fast, SPEC, J.sqmd(q=8, k=4),
        config=J.FederationConfig(rounds=1, batch_size=4, backend="jnp"),
        seed=3)
    JIO.restore_federation(str(tmp_path / "a"), ref.fed, bus=ref.bus)
    for jc, (params, opt) in zip(ref.fed.cohorts, want):
        jax.tree.map(np.testing.assert_array_equal,
                     jax.tree.map(np.asarray, jc.params), params)
        assert type(jc.opt_state).__name__ == \
            ("AdamState" if "mu" in opt else "SGDState")
        jax.tree.map(np.testing.assert_array_equal,
                     jax.tree.map(np.asarray, jc.opt_state._asdict()), opt)
    JIO.save_federation(str(tmp_path / "b"), ref.fed, step=2, bus=ref.bus)
    again, _ = _mixed(4)
    restore_federation(str(tmp_path / "b"), again.fed, bus=again.bus)
    jax.tree.map(np.testing.assert_array_equal, _state_of(again), want)
    assert again.bus.n_triggers == eng.bus.n_triggers == 2


def test_zoo_mismatch_names_the_family_and_assigns_nothing(tmp_path):
    eng, _ = _mixed(1)
    save_federation(str(tmp_path), eng.fed, step=1)
    other, _ = _mixed(3, "mlp-s,resnet,transformer",
                      "mlp-s:0.4,resnet:0.3,transformer:0.3")
    before = [p.clone() for c in other.fed.cohorts
              for p in c.model.parameters()]
    server = [t.clone() for t in other.server]
    with pytest.raises(ZooMismatchError, match="ssm"):
        restore_federation(str(tmp_path), other.fed)
    assert issubclass(ZooMismatchError, ValueError)
    after = [p for c in other.fed.cohorts for p in c.model.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert all(torch.equal(a, b) for a, b in zip(server, other.server))


def test_federate_cli_ckpt(tmp_path):
    argv = ["--device", "cpu", "--rounds", "2", "--samples-per-client",
            "12", "--ref-size", "12", "--q", "4", "--k", "2", "--clock",
            "event", "--arrivals", "cadence", "--trigger", "every-k",
            "--until", "3", "--ckpt", str(tmp_path)]
    summary = federate.main(argv)
    assert summary["ckpt"] == f"{tmp_path}/step_2.msgpack"
    tree = restore_pytree(summary["ckpt"])
    assert tree["round"] == 2 and tree["bus"]["n_triggers"] == \
        summary["server_rounds"]
    assert tree["torch"]["client_step"] > 0
    ds = pad_like(samples_per_client=12, ref_size=12)     # the CLI's data
    eng = T.AsyncFederationEngine.build(
        ds, make_splits(ds, seed=0),
        hetero_mlp_zoo(ds.feature_len, ds.n_classes), None,
        T.sqmd(q=4, k=2), device="cpu", seed=9)
    restore_federation(str(tmp_path), eng.fed, bus=eng.bus,
                       clients=eng.clients)
    assert eng.bus.n_triggers == summary["server_rounds"]
    assert eng.clients.step == tree["torch"]["client_step"]
