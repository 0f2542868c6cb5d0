"""The port's five walkthroughs (``repro_torch.examples``) on the CPU.

Each walkthrough's ``run(device="cpu")`` at the reference's published
sizes (quickstart, async_join) or cut short (train_and_serve to t=6,
train_sqmd_federation to 2 MLP rounds and 1 ResNet round, serve_decode to
4 tokens); the modules' sources (no ``jax``, no ``repro``, ``main(argv=
None)``); ``main`` with ``--device cpu``; and ``run()`` without a device,
which must raise on a box without a card. No reference federation runs
here: the report helpers are held to the reference's engines in
tests/test_torch_engine.py and tests/test_torch_async.py, and the
checkpoint file is read back by the reference's ``restore_pytree``.
"""
import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_federation
from repro_torch.core import FederationConfig, FederationEngine, sqmd
from repro_torch.data import make_splits, pad_like, sc_like
from repro_torch.examples import (async_join, quickstart, serve_decode,
                                  train_and_serve, train_sqmd_federation)
from repro_torch.launch.serve import serve
from repro_torch.models import hetero_mlp_zoo

WALKTHROUGHS = ("quickstart", "async_join", "train_and_serve",
                "train_sqmd_federation", "serve_decode")
EXAMPLES = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "examples"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The walkthroughs run many thousands of tiny ops. Beside the
    suite's other busy workers torch's default intra-op threads mostly
    wait on each other: on an 8-core host under 6 workers this file took
    ~860 s with them, and ~17 s with one thread beside five other copies
    of itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_the_package_holds_the_five_walkthroughs():
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(
        ("__init__", *WALKTHROUGHS))


@pytest.mark.parametrize("name", ("__init__", *WALKTHROUGHS))
def test_walkthrough_imports_neither_jax_nor_the_reference(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    roots = {m.split(".")[0] for m in _imports(tree)}
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    if name == "__init__":
        return
    defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    main = defs["main"].args
    assert [a.arg for a in main.args] == ["argv"]
    assert isinstance(main.defaults[0], ast.Constant) \
        and main.defaults[0].value is None
    run = defs["run"].args
    assert not run.args and run.kwonlyargs[0].arg == "device"
    assert run.kw_defaults[0].value is None


def test_the_analysis_gate_scans_the_walkthroughs():
    """The lint family (literal-device-default among it) reads every
    walkthrough and finds nothing."""
    from repro_torch.analysis.registry import AnalysisContext, run_rules
    ctx = AnalysisContext(device="cpu")
    scanned = {p.resolve() for p in ctx.python_files()}
    assert {(EXAMPLES / f"{n}.py").resolve() for n in WALKTHROUGHS} <= scanned
    results = run_rules(ctx, families=["lint"])
    assert "literal-device-default" in {r.rule for r in results}
    assert all(r.status == "ok" for r in results), results


@pytest.mark.parametrize("name", WALKTHROUGHS)
def test_run_without_a_device_takes_the_card(name):
    """``device=None`` is the card: on a box without one, run() raises
    before it trains or serves anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: run() would take it")
    module = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.run()


def test_cluster_agreement_on_a_hand_made_graph():
    cluster = np.array([0, 0, 1, 1])
    w = np.zeros((4, 4))
    w[0, 1] = w[1, 2] = w[2, 3] = w[3, 2] = 0.5
    # rows 0, 2, 3 pick their own cluster, row 1 the other one
    assert quickstart.cluster_agreement(w, cluster) == (0.75, 0.5)


def test_quickstart_at_its_published_size(capsys):
    out = quickstart.run(device="cpu")
    hist, engine = out["history"], out["engine"]
    assert hist.rounds == [0, 5, 10, 15, 20, 24]
    assert out["final_acc"] == hist.mean_acc[-1]
    # 28 clients, sqmd(q=12, k=6): every row keeps six neighbors among
    # the twelve candidates
    assert out["graph_stats"]["out_degree"] == 6.0
    assert out["graph_stats"]["n_candidates"] == 12
    agreement = (out["cluster_agreement"], out["random_agreement"])
    cluster = pad_like(samples_per_client=60, ref_size=120).client_cluster
    assert agreement == quickstart.cluster_agreement(
        engine.server.weights.numpy(), cluster)
    # similarity recovers the clusters better than a random pick
    assert agreement[0] > agreement[1]
    printed = capsys.readouterr().out
    assert printed.endswith("\n".join(quickstart.report(
        hist.mean_acc[-1], out["graph_stats"], agreement)) + "\n")


def test_async_join_at_its_published_size(capsys):
    out = async_join.run(device="cpu")
    printed = capsys.readouterr().out
    times = [0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0, 35.0, 40.0, 44.0]
    # 32 clients round-robin over the tiers join at 0, 15 and 30: 11, 22
    # and 32 active; sqmd caps the candidates at q=16, fedmd takes all
    joined = [11, 11, 11, 22, 22, 22, 32, 32, 32, 32]
    for label, cap in (("staged-sqmd", 16), ("staged-fedmd", 32)):
        rows = out[label]["rows"]
        assert [r[0] for r in rows] == times
        assert [r[4] for r in rows] == [min(cap, j) for j in joined]
        assert [r[3] for r in rows] == [int(t) + 1 for t in times]
        assert out[label]["n_triggers"] == rows[-1][3]
        assert all(async_join.format_join_row(r) in printed for r in rows)
    rows = out["straggler-quorum"]["rows"]
    assert [r[0] for r in rows] == times
    # the slow 30 % land 2.5 late: stale rows from the first late wave on
    assert rows[0][3] == 0 and all(r[3] > 0 for r in rows[1:])
    assert out["straggler-quorum"]["n_triggers"] == rows[-1][2]
    assert async_join.STALE_HEADER in printed
    assert f"uploads={out['straggler-quorum']['n_uploads']} " in printed


def test_train_and_serve_at_a_short_horizon(capsys):
    out = train_and_serve.run(device="cpu", until=6.0)
    printed = capsys.readouterr().out
    imm, micro = out["immediate"], out["micro"]
    # the same arrivals and the same training under both policies
    assert imm["summary"]["n_served"] == micro["summary"]["n_served"] > 0
    assert imm["acc"] == micro["acc"]
    assert imm["summary"]["snapshots_published"] == \
        micro["summary"]["snapshots_published"]
    # immediate flushes at each arrival instant, micro batches the bursts
    assert imm["summary"]["queue_depth_max"] <= \
        micro["summary"]["queue_depth_max"]
    assert imm["summary"]["mean_batch"] <= micro["summary"]["mean_batch"]
    assert train_and_serve.HEADER in printed
    for res in (imm, micro):
        row = train_and_serve.summary_row(res["summary"], res["acc"])
        assert row.startswith(res["summary"]["policy"]) and row in printed


@pytest.mark.parametrize("resnet,rounds", ((False, 2), (True, 1)),
                         ids=("mlp", "resnet"))
def test_train_sqmd_federation_checkpoint_reads_in_both_packages(
        tmp_path, resnet, rounds):
    from repro.checkpoint.io import restore_pytree as ref_restore_pytree
    out = train_sqmd_federation.run(device="cpu", rounds=rounds,
                                    resnet=resnet, ckpt=str(tmp_path))
    engine = out["engine"]
    assert out["checkpoint"] == str(tmp_path / f"step_{rounds}.msgpack")
    tree = ref_restore_pytree(out["checkpoint"])
    assert tree["zoo"] == out["families"] and tree["round"] == rounds
    np.testing.assert_array_equal(tree["server"]["repo_logp"],
                                  engine.server.repo_logp.numpy())
    np.testing.assert_array_equal(tree["targets"],
                                  engine.fed.targets.numpy())
    # the port restores it into a federation built from other weights
    ds = sc_like(samples_per_client=60, ref_size=120)
    splits = make_splits(ds, seed=0, label_noise=0.3)
    zoo = (train_sqmd_federation.resnet_zoo(ds.n_classes) if resnet
           else hetero_mlp_zoo(ds.feature_len, ds.n_classes))
    fresh = FederationEngine.build(
        ds, splits, zoo, None, sqmd(q=16, k=8, rho=0.8),
        config=FederationConfig(rounds=rounds), seed=5, device="cpu")
    assert restore_federation(str(tmp_path), fresh.fed) == rounds
    np.testing.assert_array_equal(fresh.evaluate(splits),
                                  engine.evaluate(splits))
    assert torch.equal(fresh.server.weights, engine.server.weights)


def test_serve_decode_grid_equals_serve():
    out = serve_decode.run(device="cpu", decode=4)
    want = serve("gemma3-1b", reduced=True, batch=4, prompt_len=48,
                 decode_len=4, device="cpu", verbose=False)
    assert out["generated"] == (4, 4)
    assert torch.equal(out["tokens"], want["tokens"])


def test_main_prints_the_report_headers(capsys, tmp_path):
    train_sqmd_federation.main(["--rounds", "1", "--ckpt", str(tmp_path),
                                "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("protocol=sqmd families=['mlp-s', 'mlp-m', "
                        "'mlp-l'] clients=32")
    assert lines[1].startswith("  [cb] round    0  acc=")
    assert lines[-1] == f"checkpoint -> {tmp_path}/step_1.msgpack"
    serve_decode.main(["--decode", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "serving gemma3-1b (reduced config, CPU)"
    assert lines[-1] == "generated token grid: (4, 2)"
