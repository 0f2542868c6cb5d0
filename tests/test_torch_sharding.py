"""The port's client-axis sharding against the reference's, on the CPU.

A CPU mesh is ``n`` entries of the CPU (the counterpart of the
reference's fake host devices): cohorts are ghost-padded to a multiple
of the mesh and split into one shard an entry, and SQMD's full
divergence rebuild splits into row strips. The fixture is the
reference's own ``setup_small`` (tests/test_client_sharding.py:
pad_like(16, 16, 16), splits seed 0, the three MLP tiers round-robin,
sqmd(q=8, k=4), 4 rounds, batch 8, eval_every 2). The reference runs
unsharded (its sharded lane needs fake host devices set before JAX is
imported) on kernel backend ``jnp``; its initial params and threefry
batch draws go into the port through ``init_params`` and
``batch_indices``. The port's ``devices=8`` runs are held against the
reference at tests/test_torch_engine.py's and test_torch_async.py's
tolerances, and against the port's own ``devices=None`` run within 1e-6
(the reference's bound for a sharded run).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.sharding as JS
import repro_torch.core as T
from repro.checkpoint import restore_federation as jax_restore
from repro.data import make_splits as jax_make_splits
from repro.data import pad_like as jax_pad_like
from repro.data.pipeline import cohort_batch_padded as jax_batch_padded
from repro.kernels import ops as jax_ops
from repro.models.mlp import hetero_mlp_zoo as jax_zoo
from repro.optim import sgd as jax_sgd
from repro_torch.checkpoint import (restore_federation, restore_pytree,
                                    save_federation)
from repro_torch.core.client import cohort_step
from repro_torch.core.similarity import divergence_matrix
from repro_torch.data import make_splits, pad_like
from repro_torch.data.pipeline import cohort_batch, cohort_batch_padded
from repro_torch.kernels import ops
from repro_torch.launch import federate, serve_federation
from repro_torch.launch.mesh import make_client_mesh as launch_mesh
from repro_torch.models import hetero_mlp_zoo
from repro_torch.optim import adam, sgd, state_tensors
from repro_torch.sharding import (CLIENT_AXIS, ClientMesh, cohort_mesh,
                                  ghost_pad_stack, ghost_rows,
                                  make_client_mesh, module_with)
from test_torch_async import _lazy_draws
from test_torch_engine import LOGIT_TOL, _stack_test

CFG = dict(rounds=4, batch_size=8, eval_every=2)
SHARD_TOL = 1e-6
# the reference's default optimizer, one object for all its engines in
# this file, so its jitted steps (static in the optimizer) compile once
JAX_SGD = jax_sgd(0.05, momentum=0.9)


def _sqmd(m):
    return m.sqmd(q=8, k=4)


@pytest.fixture(scope="module")
def setup_small():
    """The reference's fixture, and the port's twin of it."""
    ds = jax_pad_like(samples_per_client=16, ref_size=16, length=16)
    splits = jax_make_splits(ds, seed=0)
    zoo = jax_zoo(ds.feature_len, ds.n_classes)
    assignment = [list(zoo)[i % 3] for i in range(ds.n_clients)]
    pds = pad_like(samples_per_client=16, ref_size=16, length=16)
    psplits = make_splits(pds, seed=0)
    return dict(ds=ds, splits=splits, zoo=zoo, assignment=assignment,
                pds=pds, psplits=psplits,
                pzoo=hetero_mlp_zoo(pds.feature_len, pds.n_classes))


def _recorder(splits, n, n_classes, out, port):
    """An eval callback keeping every client's test logits."""
    def cb(engine, rnd, metrics):
        got = np.zeros((n, len(splits[0].test_y), n_classes))
        for coh in engine.fed.cohorts:
            xs, _ = _stack_test(splits, coh.client_ids)
            if port:
                with torch.no_grad():
                    got[coh.client_ids] = coh.real_forward(
                        torch.from_numpy(xs)).numpy()
            else:
                got[coh.client_ids] = np.asarray(
                    jax.vmap(coh.apply_fn)(coh.params, jnp.asarray(xs)))
        out.append(got)
    return cb


def _reference(s, asynchronous):
    ds, splits = s["ds"], s["splits"]
    logits = []
    cb = _recorder(splits, ds.n_clients, ds.n_classes, logits, port=False)
    cfg = J.FederationConfig(**CFG, backend="jnp")
    if asynchronous:
        eng = J.AsyncFederationEngine.build(
            ds, splits, s["zoo"], s["assignment"], _sqmd(J),
            arrivals=J.StragglerLatency(fraction=0.5, delay=2.0, seed=1),
            trigger=J.Quorum(frac=0.5), config=cfg, seed=3, callbacks=[cb],
            optimizer=JAX_SGD)
    else:
        eng = J.FederationEngine.build(ds, splits, s["zoo"], s["assignment"],
                                       _sqmd(J), config=cfg, seed=5,
                                       callbacks=[cb], optimizer=JAX_SGD)
    init = {coh.family_name: jax.tree.map(np.asarray, coh.params)
            for coh in eng.fed.cohorts}
    draws = _lazy_draws(eng, CFG["batch_size"])
    hist = (eng.fit(splits, until=4.0) if asynchronous
            else eng.fit(splits))
    return dict(eng=eng, hist=hist, logits=logits, init=init, draws=draws)


def _port(s, ref, devices, asynchronous, seam=True):
    pds, psplits = s["pds"], s["psplits"]
    logits = []
    cb = _recorder(psplits, pds.n_clients, pds.n_classes, logits, port=True)
    common = dict(config=T.FederationConfig(**CFG, devices=devices),
                  callbacks=[cb], device="cpu")
    if seam:
        common.update(init_params=ref["init"], batch_indices=ref["draws"])
    if asynchronous:
        eng = T.AsyncFederationEngine.build(
            pds, psplits, s["pzoo"], s["assignment"], _sqmd(T),
            arrivals=T.StragglerLatency(fraction=0.5, delay=2.0, seed=1),
            trigger=T.Quorum(frac=0.5), seed=3, **common)
    else:
        eng = T.FederationEngine.build(pds, psplits, s["pzoo"],
                                       s["assignment"], _sqmd(T), seed=5,
                                       **common)
    start = {coh.family_name: _snapshot(coh) for coh in eng.fed.cohorts}
    hist = (eng.fit(psplits, until=4.0) if asynchronous
            else eng.fit(psplits))
    return dict(eng=eng, hist=hist, logits=logits, start=start)


def _snapshot(coh):
    """Every shard's params and optimizer-state tensors, copied."""
    return [([p.detach().clone() for p in sh.model.parameters()],
             [t.clone() for t in state_tensors(sh.opt_state)])
            for sh in coh.shards]


@pytest.fixture(scope="module", params=["sync", "async"])
def runs(request, setup_small):
    """One clock's federation: the reference's, and the port's devices=8
    and devices=None runs on its draws."""
    asynchronous = request.param == "async"
    ref = _reference(setup_small, asynchronous)
    return dict(ref=ref, p8=_port(setup_small, ref, 8, asynchronous),
                p1=_port(setup_small, ref, None, asynchronous))


# --- the pieces against the reference's -----------------------------------

@pytest.mark.parametrize("n,n_dev", [(10, 8), (16, 8), (3, 8), (7, 1),
                                     (28, 8)])
def test_ghost_rows_match_reference(n, n_dev):
    assert ghost_rows(n, n_dev) == JS.ghost_rows(n, n_dev)


@pytest.mark.parametrize("pad", [0, 2, 5])
def test_ghost_pad_stack_matches_reference(pad):
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 2)).astype(np.float32),
            "b": np.arange(3, dtype=np.int32)}
    want = JS.ghost_pad_stack({k: jnp.asarray(v) for k, v in tree.items()},
                              pad)
    port = {k: torch.from_numpy(v) for k, v in tree.items()}
    got = ghost_pad_stack(port, pad)
    if pad == 0:
        assert got is port
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # an optimizer state: its per-client step and its moment lists pad
    # alike, and a field of None stays None
    state = sgd(0.1, momentum=0.9).init([torch.from_numpy(tree["a"])])
    padded = ghost_pad_stack(state, pad)
    assert type(padded) is type(state) and padded.step.shape == (3 + pad,)
    np.testing.assert_array_equal(padded.momentum[0].numpy(),
                                  np.asarray(JS.ghost_pad_stack(
                                      jnp.asarray(state.momentum[0].numpy()),
                                      pad)))
    assert ghost_pad_stack(sgd(0.1).init([port["a"]]), pad).momentum is None


def test_make_client_mesh_validates():
    assert CLIENT_AXIS == JS.CLIENT_AXIS
    with pytest.raises(ValueError, match="n_dev"):
        make_client_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_client_mesh(2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_mesh(2)
    mesh = make_client_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.shape == {CLIENT_AXIS: 8}
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert make_client_mesh(device="cpu").size == 1
    assert launch_mesh(8, device="cpu") == mesh
    assert cohort_mesh(mesh, 10) is mesh
    small = cohort_mesh(mesh, 2)
    assert small.size == 2 and small.devices == mesh.devices[:2]
    with pytest.raises(ValueError, match="mix"):
        ClientMesh((torch.device("cpu"), torch.device("meta")))


def test_config_and_mesh_seam_validate(setup_small):
    with pytest.raises(ValueError, match="devices"):
        T.FederationConfig(devices=0)
    assert T.FederationConfig(devices=1).devices == 1
    assert T.FederationConfig().devices is None
    s = setup_small
    mesh = make_client_mesh(8, device="cpu")
    for devices in (None, 4):
        with pytest.raises(ValueError, match="config.devices"):
            T.FederationEngine.build(
                s["pds"], s["psplits"], s["pzoo"], s["assignment"],
                _sqmd(T), config=T.FederationConfig(**CFG, devices=devices),
                device="cpu", mesh=mesh)
    eng = T.AsyncFederationEngine.build(
        s["pds"], s["psplits"], s["pzoo"], s["assignment"], _sqmd(T),
        config=T.FederationConfig(**CFG, devices=8), device="cpu", mesh=mesh)
    assert eng.mesh is mesh and eng.policy.mesh is mesh
    assert all(len(c.shards) == 8 for c in eng.fed.cohorts)
    with pytest.raises(ValueError, match="split into 8 shards"):
        eng.fed.cohorts[0].model


def test_cohort_batch_padded_matches_reference():
    """Draws at the real size (the reference's threefry draw), then
    edge-replicated: the real rows' batches equal the unpadded ones, the
    ghosts take the last real client's."""
    key = jax.random.key(3)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 12, 4)).astype(np.float32)
    y = rng.integers(0, 3, (5, 12)).astype(np.int32)
    jdata = JS.ghost_pad_stack({"x": jnp.asarray(x), "y": jnp.asarray(y)}, 3)
    want = jax_batch_padded(key, jdata, 6, 5)
    idx = torch.from_numpy(np.array(jax.random.randint(key, (5, 6), 0, 12)))
    data = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    got = cohort_batch_padded(ghost_pad_stack(data, 3), idx)
    plain = cohort_batch(data, idx)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got[k][:5].numpy(), plain[k].numpy())
        for g in range(5, 8):
            np.testing.assert_array_equal(got[k][g].numpy(),
                                          got[k][4].numpy())


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_ghost_rows_are_exact_noops(setup_small, opt):
    """A ghost-padded step with the ghosts masked out advances the real
    rows bit for bit as the unpadded step does; the ghosts keep their
    params and every optimizer-state leaf, the step counter included."""
    s = setup_small
    optimizer = sgd(0.05, momentum=0.9) if opt == "sgd" else adam(1e-2)
    model = s["pzoo"]["mlp-s"]
    from repro_torch.models.mlp import mlp_family
    gen = torch.Generator().manual_seed(0)
    n_c, pad, r, c = 10, 3, 16, s["pds"].n_classes
    model = mlp_family(model)(n_c, device=torch.device("cpu"),
                              generator=gen)
    params0 = [p.detach().clone() for p in model.parameters()]
    padded = module_with(model, ghost_pad_stack(params0, pad))
    state = optimizer.init(list(model.parameters()))
    pstate = ghost_pad_stack(state, pad)
    # one real step first, so the state is not all zeros
    x = torch.randn((n_c, 8, s["pds"].feature_len), generator=gen)
    y = torch.randint(0, c, (n_c, 8), generator=gen)
    ref_x = torch.randn((r, s["pds"].feature_len), generator=gen)
    tgt = torch.softmax(torch.randn((n_c, r, c), generator=gen), -1)
    on = torch.ones(n_c, dtype=torch.bool)
    on[2] = False
    ghost_on = torch.cat([on, torch.zeros(pad, dtype=torch.bool)])
    for _ in range(2):
        state, _ = cohort_step(model, optimizer, state, x, y, ref_x, tgt,
                               on, 0.5, True)
        pstate, _ = cohort_step(padded, optimizer, pstate,
                                ghost_pad_stack(x, pad),
                                ghost_pad_stack(y, pad), ref_x,
                                ghost_pad_stack(tgt, pad), ghost_on, 0.5,
                                True)
    for a, b, p0 in zip(model.parameters(), padded.parameters(), params0):
        torch.testing.assert_close(b[:n_c], a, rtol=0, atol=0)
        assert torch.equal(b[n_c:], p0[-1:].expand_as(b[n_c:]))
    init = ghost_pad_stack(optimizer.init([p0.clone() for p0 in params0]),
                           pad)
    for a, b, g in zip(state_tensors(state), state_tensors(pstate),
                       state_tensors(init)):
        torch.testing.assert_close(b[:n_c], a, rtol=0, atol=0)
        assert torch.equal(b[n_c:], g[n_c:])


# --- the sharded Eq. 2 rebuild ---------------------------------------------

@pytest.mark.parametrize("n", [37, 64])
def test_sharded_divergence_matches_reference(n):
    z = np.random.default_rng(n).normal(size=(n, 20, 5)) * 2
    logp = (z - np.log(np.exp(z).sum(-1, keepdims=True))).astype(np.float32)
    want = np.asarray(jax_ops.pairwise_kl(jnp.asarray(logp), backend="jnp"))
    lp = torch.from_numpy(logp)
    got = divergence_matrix(lp, mesh=make_client_mesh(8, device="cpu"))
    assert got.shape == (n, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SHARD_TOL)
    np.testing.assert_allclose(got.numpy(), ops.pairwise_kl(lp).numpy(),
                               rtol=0, atol=SHARD_TOL)


def test_sharded_sqmd_graph_selects_the_reference_neighbors(runs):
    """SQMD's full rebuild with a bus-attached 8-entry mesh picks the
    reference's one-device neighbors on the reference's trained
    repository (N=28, not a multiple of 8), from a divergence within
    1e-6."""
    jeng = runs["ref"]["eng"]
    logp, labels = jeng.server.repo_logp, jeng.fed.ref_y
    n, r, c = logp.shape
    jstate = J.upload_messengers(J.init_server(n, r, c), logp,
                                 jnp.ones((n,), bool))
    jpol = J.as_policy(_sqmd(J))
    jg = jpol.build_graph(jstate, jpol.grade(jstate, labels, backend="jnp"),
                          backend="jnp")
    tstate = T.upload_messengers(T.init_server(n, r, c, device="cpu"),
                                 torch.from_numpy(np.asarray(logp)),
                                 torch.ones(n, dtype=torch.bool))
    tpol = T.as_policy(_sqmd(T))
    tpol.mesh = make_client_mesh(8, device="cpu")
    tg = tpol.build_graph(tstate, tpol.grade(
        tstate, torch.from_numpy(np.asarray(labels))))
    assert tg.neighbors.shape == (n, 4)
    np.testing.assert_array_equal(tg.neighbors.numpy(),
                                  np.asarray(jg.neighbors))
    np.testing.assert_array_equal(tg.weights.numpy() > 0,
                                  np.asarray(jg.weights) > 0)
    np.testing.assert_allclose(tg.divergence.numpy(),
                               np.asarray(jg.divergence), rtol=0,
                               atol=SHARD_TOL)


# --- sync and async federations --------------------------------------------

def test_sharded_federation_is_padded_and_split(runs):
    for coh in runs["p8"]["eng"].fed.cohorts:
        assert coh.n_pad == ghost_rows(coh.n_clients, 8) > 0
        assert coh.n_rows % 8 == 0 and len(coh.shards) == 8
        assert [sh.start for sh in coh.shards] == list(
            range(0, coh.n_rows, coh.n_rows // 8))
        assert {sh.n_rows for sh in coh.shards} == {coh.n_rows // 8}
        np.testing.assert_array_equal(
            coh.padded_ids[coh.n_clients:], coh.client_ids[-1])


def test_sharded_federation_matches_reference(runs):
    """devices=8 against the reference's unsharded run: the History
    bookkeeping exactly, eval logits and the repository within
    LOGIT_TOL."""
    jh, th = runs["ref"]["hist"], runs["p8"]["hist"]
    for key in ("rounds", "times", "server_rounds", "staleness",
                "bytes_up", "bytes_down"):
        assert getattr(th, key) == getattr(jh, key), key
    assert len(runs["p8"]["logits"]) == len(runs["ref"]["logits"]) >= 2
    for t, j in zip(runs["p8"]["logits"], runs["ref"]["logits"]):
        np.testing.assert_allclose(t, j, rtol=0, atol=LOGIT_TOL)
    js, ts = runs["ref"]["eng"].server, runs["p8"]["eng"].server
    np.testing.assert_allclose(ts.repo_logp.numpy(), np.asarray(js.repo_logp),
                               rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    np.testing.assert_array_equal(ts.weights.numpy() > 0,
                                  np.asarray(js.weights) > 0)


def _hold_unsharded(a, b):
    """The port's devices=8 run ``a`` against its devices=None run ``b``:
    accuracies, logits, repository, targets and real params within 1e-6,
    wire bytes and fires equal."""
    ha, hb = a["hist"], b["hist"]
    np.testing.assert_allclose(ha.mean_acc, hb.mean_acc, rtol=0,
                               atol=SHARD_TOL)
    np.testing.assert_allclose(ha.val_acc, hb.val_acc, rtol=0,
                               atol=SHARD_TOL)
    assert ha.bytes_up == hb.bytes_up and ha.bytes_down == hb.bytes_down
    assert ha.server_rounds == hb.server_rounds
    for t, u in zip(a["logits"], b["logits"]):
        np.testing.assert_allclose(t, u, rtol=0, atol=SHARD_TOL)
    fa, fb = a["eng"].fed, b["eng"].fed
    np.testing.assert_allclose(fa.server.repo_logp.numpy(),
                               fb.server.repo_logp.numpy(), rtol=0,
                               atol=SHARD_TOL)
    np.testing.assert_allclose(fa.targets.numpy(), fb.targets.numpy(),
                               rtol=0, atol=SHARD_TOL)
    for ca, cb in zip(fa.cohorts, fb.cohorts):
        for (k, x), (_, y) in zip(ca.real_params.items(),
                                  cb.real_params.items()):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                       atol=SHARD_TOL, err_msg=k)


def test_sharded_federation_matches_unsharded(runs):
    _hold_unsharded(runs["p8"], runs["p1"])


def test_padding_leaves_the_generator_stream_alone(setup_small):
    """Without the draws seam both runs draw from the port's generator at
    the real cohort sizes, so padding changes no batch."""
    _hold_unsharded(*(_port(setup_small, None, d, False, seam=False)
                      for d in (8, None)))


def test_small_cohort_takes_a_submesh(setup_small):
    """A 2-client cohort on an 8-entry mesh lives on the mesh's first 2
    entries, one real row each and no ghost; the run still equals the
    unsharded one."""
    s = setup_small
    assignment = ["mlp-m" if i in (3, 17) else ("mlp-s", "mlp-l")[i % 2]
                  for i in range(s["pds"].n_clients)]
    out = []
    for devices in (8, None):
        eng = T.FederationEngine.build(
            s["pds"], s["psplits"], s["pzoo"], assignment, _sqmd(T),
            config=T.FederationConfig(**CFG, devices=devices), seed=5,
            device="cpu")
        out.append(dict(eng=eng, hist=eng.fit(s["psplits"]), logits=[]))
    small = out[0]["eng"].fed.cohorts[1]
    assert small.family_name == "mlp-m" and small.n_clients == 2
    assert small.mesh.size == 2 and small.n_pad == 0
    assert [sh.n_rows for sh in small.shards] == [1, 1]
    _hold_unsharded(*out)


def test_ghost_rows_unchanged_after_the_fit(runs):
    """Every ghost row keeps its params and optimizer state bit for bit
    through the whole fit."""
    eng, start = runs["p8"]["eng"], runs["p8"]["start"]
    n_ghost_shards = 0
    for coh in eng.fed.cohorts:
        now = _snapshot(coh)
        for sh, (p0, s0), (p1, s1) in zip(coh.shards, start[coh.family_name],
                                          now):
            real = coh.real_rows(sh)
            n_ghost_shards += real < sh.n_rows
            for a, b in zip(p0 + s0, p1 + s1):
                assert torch.equal(a[real:], b[real:])
    assert n_ghost_shards > 0


def test_devices_one_is_bit_identical(setup_small):
    """devices=1 goes through the mesh (one shard, no ghosts) and equals
    devices=None bit for bit."""
    s = setup_small
    out = []
    for devices in (None, 1):
        eng = T.FederationEngine.build(
            s["pds"], s["psplits"], s["pzoo"], s["assignment"], _sqmd(T),
            config=T.FederationConfig(**CFG, devices=devices), seed=5,
            device="cpu")
        out.append((eng, eng.fit(s["psplits"])))
    (e0, h0), (e1, h1) = out
    assert e1.mesh.size == 1 and e0.mesh is None
    assert h1.mean_acc == h0.mean_acc and h1.val_acc == h0.val_acc
    assert torch.equal(e1.server.repo_logp, e0.server.repo_logp)
    assert torch.equal(e1.fed.targets, e0.fed.targets)
    for c0, c1 in zip(e0.fed.cohorts, e1.fed.cohorts):
        for a, b in zip(c0.model.parameters(), c1.model.parameters()):
            assert torch.equal(a, b)


# --- checkpoints ------------------------------------------------------------

def test_sharded_checkpoint_crosses_layouts_and_packages(setup_small,
                                                         tmp_path):
    """A sharded save holds real rows only and equals the unsharded
    save; it restores unsharded, sharded again (ghosts re-padded), and
    into the reference."""
    s = setup_small

    def build(devices, seed):
        return T.FederationEngine.build(
            s["pds"], s["psplits"], s["pzoo"], s["assignment"], _sqmd(T),
            config=T.FederationConfig(**CFG, devices=devices), seed=seed,
            device="cpu")

    e8, e1 = build(8, 5), build(None, 5)
    for eng in (e8, e1):
        for rnd in range(2):
            eng.run_round(rnd)
    acc8 = e8.evaluate(s["psplits"])
    d8, d1 = tmp_path / "sharded", tmp_path / "whole"
    save_federation(str(d8), e8.fed, step=2, bus=e8.bus, clients=e8.clients)
    save_federation(str(d1), e1.fed, step=2, bus=e1.bus, clients=e1.clients)
    f8 = restore_pytree(str(d8 / "step_2.msgpack"))
    f1 = restore_pytree(str(d1 / "step_2.msgpack"))
    for c8, c1, coh in zip(f8["cohorts"], f1["cohorts"], e8.fed.cohorts):
        w8, w1 = c8["params"]["layers"], c1["params"]["layers"]
        assert w8[0]["w"].shape[0] == coh.n_clients
        for a, b in zip(w8, w1):
            np.testing.assert_allclose(a["w"], b["w"], rtol=0,
                                       atol=SHARD_TOL)
        np.testing.assert_array_equal(c8["opt_state"]["step"],
                                      c1["opt_state"]["step"])

    back = build(None, 99)
    restore_federation(str(d8), back.fed, bus=back.bus, clients=back.clients)
    np.testing.assert_allclose(back.evaluate(s["psplits"]), acc8, atol=1e-6)
    assert back.bus.n_triggers == e8.bus.n_triggers

    again = build(8, 42)
    restore_federation(str(d8), again.fed, bus=again.bus,
                       clients=again.clients)
    np.testing.assert_allclose(again.evaluate(s["psplits"]), acc8, atol=1e-6)
    for coh, live in zip(again.fed.cohorts, e8.fed.cohorts):
        # the real rows as saved; the ghosts copy the restored last real
        # row (the live run's ghosts still hold its initial one)
        for (k, a), (_, b) in zip(coh.real_params.items(),
                                  live.real_params.items()):
            assert torch.equal(a, b), k
        for sh in coh.shards:
            real = coh.real_rows(sh)
            for p, t in zip(sh.model.parameters(),
                            coh.real_params.values()):
                assert torch.equal(p[real:],
                                   t[-1:].expand_as(p[real:]))
        for a, b in zip(state_tensors(coh.real_opt_state),
                        state_tensors(live.real_opt_state)):
            assert torch.equal(a, b)
    again.run_round(2)
    e8.run_round(2)
    np.testing.assert_allclose(again.evaluate(s["psplits"]),
                               e8.evaluate(s["psplits"]), atol=1e-6)

    jeng = J.FederationEngine.build(
        s["ds"], s["splits"], s["zoo"], s["assignment"], _sqmd(J),
        config=J.FederationConfig(**CFG, backend="jnp"), seed=11,
        optimizer=JAX_SGD)
    assert jax_restore(str(d8), jeng.fed) == 2
    for jc, tc in zip(jeng.fed.cohorts, back.fed.cohorts):
        for jl, (w, b) in zip(jc.params["layers"],
                              zip(tc.model.w, tc.model.b)):
            np.testing.assert_array_equal(np.asarray(jl["w"]),
                                          w.detach().numpy())
            np.testing.assert_array_equal(np.asarray(jl["b"]),
                                          b.detach().numpy())
    np.testing.assert_allclose(J.evaluate(jeng.fed, s["splits"]), acc8,
                               atol=1e-6)


# --- the CLIs ----------------------------------------------------------------
# The reference CLIs run unsharded: their ``--devices`` path commits every
# array to a mesh sharding, so each of their jits compiles anew (~8 s
# on a CPU host). They add "devices" to the summary exactly when it is given, so
# the port's sharded summary must hold the reference's keys and
# "devices". One family and one round keep the reference's compiles few.

CLI = ["--samples-per-client", "16", "--ref-size", "16", "--q", "8", "--k",
       "4", "--eval-every", "1", "--zoo", "mlp-s"]


def test_federate_cli_devices_matches_reference(monkeypatch, capsys):
    from repro.launch import federate as jax_federate
    argv = [*CLI, "--rounds", "1"]
    monkeypatch.setattr("sys.argv", ["federate", *argv, "--backend", "jnp"])
    jax_federate.main()
    out = capsys.readouterr().out
    want = json.loads(out[out.index("\n{\n") + 1:])
    got = federate.main(["--device", "cpu", *argv, "--devices", "8"])
    assert set(got) >= set(want) | {"devices"} and "devices" not in want
    assert got["devices"] == 8
    for key in ("policy", "dataset", "clock", "rounds", "virtual_time",
                "server_rounds", "staleness", "uplink", "downlink",
                "bytes_up", "bytes_down", "schedule", "zoo"):
        assert got[key] == want[key], key
    assert 0.0 <= got["final_acc"] <= 1.0 and got["device"] == "cpu"
    assert "devices" not in federate.main(["--device", "cpu", *argv])
    with pytest.raises(SystemExit):
        federate.main(["--device", "cpu", "--devices", "0"])


def test_serve_federation_cli_devices_matches_reference(monkeypatch,
                                                        tmp_path):
    from repro.launch import serve_federation as jax_serve
    argv = [*CLI, "--until", "1"]
    out = tmp_path / "ref.json"
    monkeypatch.setattr("sys.argv", ["serve_federation", *argv, "--json",
                                     str(out)])
    jax_serve.main()
    want = json.loads(out.read_text())
    got = serve_federation.main(["--device", "cpu", *argv, "--devices", "8",
                                 "--json", os.fspath(tmp_path / "p.json")])
    assert set(got) >= set(want) | {"devices"} and "devices" not in want
    assert set(got["serving"]) == set(want["serving"])
    assert got["devices"] == 8
    for key in ("policy", "dataset", "until", "clients", "server_rounds",
                "train_staleness"):
        assert got[key] == want[key], key
    assert got["serving"]["n_served"] == want["serving"]["n_served"] > 0
