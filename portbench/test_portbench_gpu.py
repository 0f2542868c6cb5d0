"""On the card, at sizes a test run holds: a run of each configuration is
correct, and the control (the reference in TF32 in the port's place) is
not. Marked ``gpu``; skips without an sm_90 card.

    PYTHONPATH=src python -m pytest -m gpu portbench/test_portbench_gpu.py
"""
import pytest
import torch

from portbench import check, harness
from portbench.inputs import make_inputs
from portbench.tiny import tiny_cell

SIZES = {
    "sc-resnet1d-n128.all-on": dict(
        n_clients=12, length=64, samples_per_client=400, ref_size=240,
        q=8, k=4, batch_size=16, warm_seconds=1.0),
    "sc-resnet1d-n128.dropout50": dict(
        n_clients=12, length=64, samples_per_client=400, ref_size=240,
        q=8, k=4, batch_size=16, warm_seconds=1.0),
}
SEEDS = (4_000_000_001, 4_000_000_002, 4_000_000_003)


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an NVIDIA sm_90 card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SIZES))
def test_run_on_the_card_is_correct(card, name):
    result = harness.run(tiny_cell(name, **SIZES[name]), SEEDS[0], 1.0,
                         False, device=card)
    assert result["correct"], result["checked"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_on_the_card_is_not_correct(card, name, seed):
    cell = tiny_cell(name, **SIZES[name])
    inputs = make_inputs(cell.config, cell.traffic, seed, card)
    obs, _ = check.replay(inputs, card, precision="tf32")
    _, nums = check.replay(inputs, card, judge=obs)
    ok, shown = check.verdict(nums, cell.limits)
    assert not ok, shown
