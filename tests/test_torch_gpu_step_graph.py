"""The client step as CUDA graphs on the card (``gpu``-marked: skips
without an sm_90 card). This file imports no JAX:

    PYTHONPATH=src python -m pytest -m gpu --noconftest \
        tests/test_torch_gpu_step_graph.py

A federation of the benchmark's ResNet-1D 8/20/50 families at their
widths, 12 clients on ``sc_like``'s shapes, runs 5 rounds always on and
under dropout p=0.5, beside an eager twin that calls ``cohort_step``
directly on the same inputs: params and every optimizer-state leaf equal
bit for bit after each round. Rounds 0 and 1 run eagerly (the warm-ups
of ``use_ref`` False and True), round 2 captures one graph a cohort and
replays it, later rounds replay. A checkpoint restore that rewinds a
round and reassigns the optimizer state replays the same graphs from the
restored state and matches the uninterrupted twin.
"""
import pytest
import torch

from portbench import program
from portbench.inputs import make_inputs
from portbench.tiny import tiny_cell
from repro_torch import trace
from repro_torch.checkpoint import restore_federation, save_federation
from repro_torch.core import client, runtime
from repro_torch.data.pipeline import cohort_batch_padded
from repro_torch.optim import state_tensors

CELLS = ("sc-resnet1d-n128.all-on", "sc-resnet1d-n128.dropout50")
SIZES = dict(n_clients=12, length=64, samples_per_client=400,
             ref_size=240, q=8, k=4, batch_size=16, warm_seconds=0.0)
SEED = 2_718_281_861
ROUNDS = 5


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an NVIDIA sm_90 card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _eager_step(cohort, idx, ref_x, targets, trainable, rho, use_ref):
    """Every shard's ``cohort_step``, called directly."""
    for sh in cohort.shards:
        lo, hi = sh.start, sh.start + sh.n_rows
        batch = cohort_batch_padded(
            sh.data, idx[min(lo, cohort.n_clients - 1):hi])
        sh.opt_state, _ = client.cohort_step(
            sh.model, cohort.optimizer, sh.opt_state, batch["x"],
            batch["y"], ref_x, targets[lo:hi], trainable[lo:hi], rho,
            use_ref)


def _engines(name, card):
    cell = tiny_cell(name, **SIZES)
    inputs = make_inputs(cell.config, cell.traffic, SEED, card, cell.root)
    return (program.build(inputs, card, cell.root),
            program.build(inputs, card, cell.root))


def _round(engine, rnd, eager=False):
    """The ``graph.*`` counters of one recorded round; ``eager`` steps
    through ``_eager_step``."""
    with pytest.MonkeyPatch.context() as m:
        if eager:
            m.setattr(runtime, "sharded_cohort_step", _eager_step)
        with trace.recording() as rec:
            engine.run_round(rnd)
    torch.cuda.synchronize()
    return {k: v for k, v in rec.counters.items() if k.startswith("graph.")}


def _assert_equal(a, b):
    for ca, cb in zip(a.fed.cohorts, b.fed.cohorts):
        for p, q in zip(ca.model.parameters(), cb.model.parameters()):
            assert torch.equal(p, q), ca.family_name
        for s, t in zip(state_tensors(ca.opt_state),
                        state_tensors(cb.opt_state)):
            assert torch.equal(s, t), ca.family_name
    assert torch.equal(a.fed.targets, b.fed.targets)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_graph_steps_equal_eager_steps(card, name):
    graphed, twin = _engines(name, card)
    n = len(graphed.fed.cohorts)
    want = [{"graph.eager": n}, {"graph.eager": n},
            {"graph.captures": n, "graph.replays": n}]
    for rnd in range(ROUNDS):
        got = _round(graphed, rnd)
        assert _round(twin, rnd, eager=True) == {}
        assert got == (want[rnd] if rnd < len(want)
                       else {"graph.replays": n}), rnd
        _assert_equal(graphed, twin)
    assert all(sh.graphs.captured() == 1 for c in graphed.fed.cohorts
               for sh in c.shards)


@pytest.mark.gpu
def test_restore_reassigning_the_state_replays_from_it(card, tmp_path):
    graphed, twin = _engines(CELLS[1], card)
    n = len(graphed.fed.cohorts)
    for rnd in range(ROUNDS):
        _round(twin, rnd, eager=True)
    for rnd in range(3):
        _round(graphed, rnd)
    save_federation(str(tmp_path), graphed.fed, step=3, bus=graphed.bus,
                    clients=graphed.clients)
    _round(graphed, 3)
    held = [state_tensors(c.opt_state) for c in graphed.fed.cohorts]
    # rewind round 3: new state tensors, params written in place
    restore_federation(str(tmp_path), graphed.fed, bus=graphed.bus,
                       clients=graphed.clients)
    assert not any(a is b for c, h in zip(graphed.fed.cohorts, held)
                   for a, b in zip(state_tensors(c.opt_state), h))
    for rnd in (3, 4):
        assert _round(graphed, rnd) == {"graph.replays": n}
    _assert_equal(graphed, twin)
