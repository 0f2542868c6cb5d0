"""A run of each configuration at a tiny size on the CPU, past the look
for a card: the port against the plain reference, the result's keys,
the control and each fault the output check must catch, and the inputs
made from the seed."""
import json

import numpy as np
import pytest
import torch

from portbench import availability, check, harness, program
from portbench.inputs import make_inputs
from portbench.tiny import tiny_cell

RESNET = "sc-resnet1d-n128.all-on"
DROPOUT = "sc-resnet1d-n128.dropout50"
SEED = 3_000_000_017          # past 32 signed bits, as run seeds may be


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _run(name, trace=False, **sizes):
    errs = []

    class Err:
        def write(self, s):
            errs.append(s)

    result = harness.run(tiny_cell(name, **sizes), SEED, 0.02, trace,
                         device="cpu", err=Err(), threads=1)
    return result, "".join(errs)


@pytest.mark.parametrize("name", [RESNET, DROPOUT])
def test_port_matches_reference(name):
    result, err = _run(name)
    assert result["correct"], result["checked"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checked"
    assert set(result["checked"]) == set(check.NUMBERS)
    lines = err.strip().splitlines()[-len(check.NUMBERS):]
    assert [ln.split()[0] for ln in lines] == list(check.NUMBERS)
    assert all(" limit " in ln for ln in lines)
    json.dumps(result)
    names = {m["name"] for m in tiny_cell(name).end_to_end}
    assert set(result["metrics"]) == names


def test_traced_run_reports_span_metrics(monkeypatch):
    # the fewest rounds the spans and the profiler take
    monkeypatch.setattr(harness, "SPAN_SECONDS", 0.0)
    monkeypatch.setattr(harness, "PROFILE_SECONDS", 0.0)
    result, _ = _run(RESNET, trace=True)
    assert result["correct"]
    got = set(result["metrics"])
    assert {"client_step_ms", "upload_ms", "server_round_ms"} <= got
    assert "breakdown" in result and list(result)[-1] == "checked"


def _fault_frozen(monkeypatch):
    import repro_torch.core.runtime as rt
    monkeypatch.setattr(rt, "sharded_cohort_step", lambda *a, **k: None)


def _fault_half_batch(monkeypatch):
    import repro_torch.core.distill as distill
    orig = distill.local_loss
    monkeypatch.setattr(distill, "local_loss", lambda logits, y: orig(
        logits[:, :logits.shape[1] // 2], y[:, :y.shape[1] // 2]))


def _fault_answer(monkeypatch):
    import repro_torch.core.client as client
    orig = client.cohort_messengers

    def altered(model, ref_x, codec=None):
        from repro_torch.core import wire
        logp = orig(model, ref_x)
        logp = logp.clone()
        logp[0] = torch.roll(logp[0], 1, dims=-1)
        return wire.encode(codec, logp, domain="log") if codec else logp
    monkeypatch.setattr(client, "cohort_messengers", altered)


@pytest.mark.parametrize("plant", [_fault_frozen, _fault_half_batch,
                                   _fault_answer],
                         ids=["frozen", "half_batch", "answer"])
@pytest.mark.parametrize("name", [RESNET, DROPOUT])
def test_fault_in_the_port_is_not_correct(monkeypatch, plant, name):
    plant(monkeypatch)
    result, _ = _run(name)
    assert not result["correct"], result["checked"]


@pytest.mark.parametrize("name", [RESNET, DROPOUT])
def test_control_in_tf32_is_not_correct(name):
    """The reference in TF32 (operands rounded; no TF32 unit here) put in
    the port's place fails the limits."""
    cell = tiny_cell(name)
    inputs = make_inputs(cell.config, cell.traffic, SEED, "cpu")
    obs, _ = check.replay(inputs, "cpu", precision="tf32")
    _, nums = check.replay(inputs, "cpu", judge=obs)
    ok, shown = check.verdict(nums, cell.limits)
    assert not ok, shown


def test_engine_starts_from_the_benchmark_weights():
    """The weights go in through ``init_params=`` and read back as made."""
    cell = tiny_cell(RESNET)
    inputs = make_inputs(cell.config, cell.traffic, SEED, "cpu")
    engine = program.build(inputs, "cpu")
    got = program.read_clients(engine, cell.config)
    assert set(got) == set(inputs.weights)
    for fam, leaves in inputs.weights.items():
        assert set(got[fam]["params"]) == set(leaves)
        for k, v in leaves.items():
            assert torch.equal(got[fam]["params"][k], v), (fam, k)


def test_inputs_follow_the_seed():
    cell = tiny_cell(DROPOUT)
    a = make_inputs(cell.config, cell.traffic, SEED, "cpu")
    b = make_inputs(cell.config, cell.traffic, SEED, "cpu")
    c = make_inputs(cell.config, cell.traffic, SEED + 1, "cpu")
    for k in ("x", "y", "ref_x", "ref_y", "cluster"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert not np.array_equal(a.x, c.x)
    for f in a.weights:
        for leaf in a.weights[f]:
            assert torch.equal(a.weights[f][leaf], b.weights[f][leaf])
    assert np.array_equal(a.draws(3, 1), b.draws(3, 1))
    assert np.array_equal(a.available(4), b.available(4))
    assert 0 < a.available(4).sum() < a.n_clients
    assert availability.mask({"schedule": "always-on"}, SEED, 0, 5).all()
