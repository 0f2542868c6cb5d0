"""The program's spans as the benchmark reads them: a recorded sub-window
of a tiny CPU run gives the five readers of ``PROGRAM`` a number each,
an empty ``Context`` gives None, and a port without a tracer records
nothing and raises nothing. On the card (``gpu``): the program's count
of host syncs in a round equals the card's own, and its profiler ranges
add no device operation.

    PYTHONPATH=src python -m pytest -m gpu \\
        portbench/test_portbench_program_trace.py
"""
import sys
import time

import pytest
import torch

from portbench import program, program_trace, spec, tracing
from portbench.inputs import make_inputs
from portbench.tiny import tiny_cell

CELLS = ("sc-resnet1d-n128.all-on", "sc-resnet1d-n128.dropout50")
READERS = ("client_forward_ms", "client_backward_ms", "client_optimizer_ms",
           "host_syncs_per_round", "sync_wait_ms")
SEED = 3_000_000_019
CARD_SIZES = dict(n_clients=12, length=64, samples_per_client=400,
                  ref_size=240, q=8, k=4, batch_size=16, warm_seconds=0.0)


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _context(cell) -> tracing.Context:
    return tracing.Context(config=cell.config, n_clients=1, ref_size=1,
                           n_classes=1, length=1, peaks={})


def _engine(name, device, **sizes):
    cell = tiny_cell(name, **sizes)
    inputs = make_inputs(cell.config, cell.traffic, SEED, device, cell.root)
    return cell, program.build(inputs, device, cell.root)


class _Err:
    def __init__(self):
        self.text = ""

    def write(self, s):
        self.text += s


@pytest.mark.parametrize("name", CELLS)
def test_recorded_rounds_give_the_five_metrics(name):
    cell, engine = _engine(name, "cpu")
    engine.run_round(0)
    err = _Err()
    ctx = _context(cell)
    ctx.program = program_trace.record(engine, range(1, 3), "cpu", 1.0,
                                       err=err)
    assert ctx.program["rounds"] == 2
    assert "2 rounds" in err.text and "the window 1.000" in err.text
    got = {m: spec.metric_reader(m).read(ctx) for m in READERS}
    assert all(v is not None and v >= 0 for v in got.values()), got
    # 14, and one for each cohort with awake clients: all three all-on
    syncs = got["host_syncs_per_round"]
    assert syncs == 17 if name.endswith("all-on") else 14 <= syncs <= 17
    step = ctx.program["names"]["client.step"]["total_s"]
    parts = sum(got[m] for m in READERS[:3]) * ctx.program["rounds"] / 1e3
    assert parts <= step
    assert all(spec.metric_reader(m).PROGRAM for m in READERS)


@pytest.mark.parametrize("reader", READERS)
def test_an_empty_context_reads_none(reader):
    ctx = _context(tiny_cell(CELLS[0]))
    assert spec.metric_reader(reader).read(ctx) is None
    ctx.program = {}
    assert spec.metric_reader(reader).read(ctx) is None


def test_a_port_without_the_tracer_records_nothing(monkeypatch):
    import repro_torch.trace  # noqa: F401
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "trace")
    assert program_trace.record(None, range(3), "cpu", 1.0) == {}


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an NVIDIA sm_90 card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_host_syncs_are_the_cards_own_count(card, name):
    """Each blocking sync the card warns of in a round lies inside one of
    the program's sync spans, one to a span; a sync no span holds names
    its place."""
    _, engine = _engine(name, card, **CARD_SIZES)
    for rnd in range(3):
        engine.run_round(rnd)
    torch.cuda.synchronize()
    got = program_trace.sync_debug_round(engine, 3)
    assert not got["stray"], "syncs outside the program's sync spans:\n" \
        + "\n".join(got["stray"])
    assert not got["doubled"] and not got["empty"], got
    assert got["host_syncs"] == got["warnings"] > 0


@pytest.mark.gpu
def test_program_ranges_add_no_device_operation(card, monkeypatch):
    """In one profile, a round with the program's ranges and the same
    round of a twin engine (same inputs) without them, the card idle
    between them, run the same device operations."""
    from repro_torch import trace
    from torch.profiler import ProfilerActivity, profile
    engines = [_engine(CELLS[0], card, **CARD_SIZES)[1] for _ in range(2)]
    for engine in engines:
        for rnd in range(3):
            engine.run_round(rnd)

    def idle(mark):
        torch.cuda.synchronize()
        with torch.profiler.record_function(mark):
            time.sleep(0.05)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=card).add_(1)
        idle("portbench:start")
        engines[0].run_round(3)
        idle("portbench:between")
        monkeypatch.setattr(trace, "span", lambda *a, **kw: trace._OFF)
        monkeypatch.setattr(trace, "sync", lambda site: trace._OFF)
        engines[1].run_round(3)
        torch.cuda.synchronize()
    events = prof.events()
    cut = {e.name: 0.5 * (e.time_range.start + e.time_range.end)
           for e in events if e.name.startswith("portbench:")}
    dev = [e for e in tracing._device_events(events)
           if e.time_range.start > cut["portbench:start"]]
    with_ranges = sorted(e.name for e in dev
                         if e.time_range.end < cut["portbench:between"])
    without = sorted(e.name for e in dev
                     if e.time_range.start > cut["portbench:between"])
    assert len(with_ranges) + len(without) == len(dev)
    assert with_ranges == without
    ranges = [e for e in events if e.name in ("round", "client.forward")]
    assert ranges and all(e.time_range.end < cut["portbench:between"]
                          for e in ranges)
