"""The benchmark's files: finding a cell's configuration, mix, metrics,
kinds and limits by name (also for one added in another checkout without
editing a file), the contract's shape of ``BENCHMARK.json``, the counts
behind the MFU share, and the readers' silence where there is nothing
to read."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import check, spec, tracing
from portbench.metrics import round_mfu_pct
from portbench.peaks import peaks
from portbench.reference import resnet1d

H100 = peaks("NVIDIA H100 80GB HBM3")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert set(cell.limits["numbers"]) == set(check.NUMBERS)
        for name, mod in spec.metric_readers(cell).items():
            assert callable(mod.read), name
        for fam in cell.config["families"]:
            assert callable(spec.family_adapter(fam["kind"]).init_params)
            assert callable(spec.reference_kind(fam["kind"]).forward)
        assert {m["name"] for m in cell.end_to_end} >= {"round_ms",
                                                        "setup_s"}
        assert cell.per_layer


def test_a_cell_added_by_files_alone(tmp_path):
    """A new mix and metric, and a cell that names them, found in another
    checkout whose existing files are left as they are."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(spec.ROOT / "portbench" / sub,
                        tmp_path / "portbench" / sub)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    (tmp_path / "portbench/traffic/dropout90.json").write_text(
        '{"schedule": "dropout", "p": 0.9}')
    (tmp_path / "portbench/metrics/awake_share_pct.py").write_text(
        "def read(ctx):\n    return 100.0 * ctx.awake_share\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "sc-resnet1d-n128.dropout90",
        "config": "sqmd-sc-resnet1d-n128", "traffic": "dropout90",
        "chips": 1, "why": "nine in ten asleep"})
    bench["per_layer"].append({
        "name": "awake_share_pct", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "device", "moves": "round_ms",
        "workloads": ["sc-resnet1d-n128.dropout90"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("sc-resnet1d-n128.dropout90", tmp_path)
    assert cell.traffic == {"schedule": "dropout", "p": 0.9}
    readers = spec.metric_readers(cell)
    assert "awake_share_pct" in readers
    ctx = tracing.Context(cell.config, 1, 1, 1, 1, {}, awake_share=0.1)
    assert readers["awake_share_pct"].read(ctx) == pytest.approx(10.0)
    for path, data in before.items():
        if path.name != "BENCHMARK.json":
            assert path.read_bytes() == data


def test_benchmark_json_keeps_the_contract_shape():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    metric_names = [m["name"] for m in bench["end_to_end"]
                    + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for name in metric_names + [w["name"] for w in bench["workloads"]]:
        assert NAME.match(name), name
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in bench["workloads"]}
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    assert all(w["chips"] == 1 for w in bench["workloads"])


def test_eq2_counts_at_n10240():
    assert round_mfu_pct.eq2_operations(10240, 240, 10) == 503_316_480_000
    assert round_mfu_pct.eq2_operations(128, 240, 3) == 23_592_960


def test_model_flop_counts():
    r8 = {"blocks": [1, 1, 1], "width": 16, "bottleneck": False}
    # stem 2*1*3*16*64, stage 0 two 16->16 convs at 64, stage 1 two convs
    # and a 1x1 skip at 32, stage 2 likewise at 16, head 2*64*3
    want = (6144 + 2 * 98304 + (98304 + 196608 + 32768)
            + (196608 + 393216 + 65536) + 384)
    assert resnet1d.forward_flops(r8, 64, 3, 64) == want


def test_round_flops_of_the_resnet_cell():
    cfg = spec.load_cell("sc-resnet1d-n128.all-on").config
    each = [(resnet1d.forward_flops(f, 64, 3, 64),
             resnet1d.backward_flops(f, 64, 3, 64)) for f in cfg["families"]]
    # 128 clients round-robin over three families: 43 / 43 / 42
    want = sum(n * ((fwd + bwd) * (16 + 240) + fwd * 240)
               for n, (fwd, bwd) in zip((43, 43, 42), each))
    got = round_mfu_pct.client_flops(cfg, 64, 3, 64, 240)
    assert got == pytest.approx(want)
    server = round_mfu_pct.server_flops(cfg, 240, 3)
    assert server == 2 * 128 * 128 * 240 * 3 + 2 * 128 * 8 * 240 * 3


def test_readers_are_silent_without_data():
    cfg = spec.load_cell("sc-resnet1d-n128.all-on").config
    ctx = tracing.Context(cfg, 128, 240, 3, 64, H100)
    for mod in ("client_step_ms", "upload_ms", "server_round_ms",
                "device_idle_pct", "device_busy_ms", "launches_per_round",
                "round_mfu_pct"):
        assert spec.metric_reader(mod).read(ctx) is None, mod
    ctx.window = {"rounds": 10, "seconds": 3.0}
    assert spec.metric_reader("round_mfu_pct").read(ctx) > 0
    ctx.peaks = {}
    assert spec.metric_reader("round_mfu_pct").read(ctx) is None


def test_no_module_of_the_benchmark_imports_jax():
    """Each source's imports, and a process that imports the harness."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    for path in (spec.ROOT / "portbench").rglob("*.py"):
        for line in path.read_text().splitlines():
            m = re.match(r"\s*(?:from|import)\s+([A-Za-z_][\w]*)", line)
            if m:
                assert m.group(1) not in banned, (path, line)
    code = ("import sys; import portbench.harness, portbench.calibrate, "
            "repro_torch.core, repro_torch.models, repro_torch.kernels.ops, "
            "portbench.check, portbench.program; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(banned)!r}); print(bad); sys.exit(1 if bad else 0)")
    root = str(spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env={"PYTHONPATH": f"{root}:{root}/src",
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_run_refuses_without_a_card(capsys, monkeypatch):
    import torch
    from portbench import harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = harness.main(["--workload", "sc-resnet1d-n128.all-on", "--seed",
                         "1", "--seconds", "1"])
    assert code != 0
    assert capsys.readouterr().out == ""


def test_run_prints_nothing_with_jax_loaded(capsys, monkeypatch):
    """A run whose process holds a module named ``jax`` (by its top-level
    name) exits without a result."""
    import types

    import torch
    from portbench import harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run", lambda *a, **k: {"correct": True})
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax"))
    code = harness.main(["--workload", "sc-resnet1d-n128.all-on", "--seed",
                         "1", "--seconds", "1"])
    assert code != 0
    assert capsys.readouterr().out == ""
    assert "repro_torch" not in harness.FORBIDDEN
    assert not any(m.split(".")[0] in harness.FORBIDDEN
                   for m in ("repro_torch", "repro_torch.core"))
