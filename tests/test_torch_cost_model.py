"""The port's static cost model (``repro_torch.analysis.cost``): the
interpreter's semantics on small graphs, exact counts against closed
forms, the reference's pinned policy (read from its ``cost_budgets.json``
as data), every cost rule on a seeded bug, and the whole gate on the port
with an empty baseline.

The cost family is priced once for the module (``ctx``): its traces run
in a few worker processes, the reference dims shared with the sweeps.
"""
import json
from pathlib import Path

import pytest
import torch

import repro_torch.analysis  # noqa: F401  (registers the rules)
from repro_torch.analysis import graphlib
from repro_torch.analysis.cost import entries, interp, model, rules
from repro_torch.analysis.registry import (AnalysisContext, get_rule,
                                           run_rules)
from repro_torch.launch import analyze

REPO = Path(__file__).resolve().parent.parent
REF_BUDGETS = json.loads(
    (REPO / "src/repro/analysis/cost/cost_budgets.json").read_text())


@pytest.fixture(scope="module")
def ctx():
    return AnalysisContext(device="cpu")


def _summary(fn, *args):
    return interp.summary_of(fn, *args)


# --------------------------------------------------------------------------
# interpreter semantics
# --------------------------------------------------------------------------

def test_matmul_flops_are_flop_counters():
    s = _summary(lambda x, y: x @ y, torch.zeros(8, 32), torch.zeros(32, 16))
    assert s.flops_by_op["mm"] == 2.0 * 8 * 16 * 32 == s.matmul_flops


def test_elementwise_chain_fuses_away():
    # exp -> mul -> add, one consumer each: the intermediates stay in
    # registers, one read and one write reach memory
    s = _summary(lambda v: torch.exp(v) * 2.0 + 1.0, torch.zeros(1024))
    assert s.temp_bytes == 0.0
    assert s.bytes == pytest.approx(2 * 1024 * 4, rel=0.1)
    assert s.flops == interp.TRANSCENDENTAL_WEIGHT * 1024 + 2 * 1024


def test_multi_consumer_intermediate_materializes():
    def f(v):
        p = torch.exp(v)
        return p @ v.T + torch.sum(p * v)

    s = _summary(f, torch.zeros(64, 64))
    assert s.temp_bytes >= 64 * 64 * 4


def test_in_place_update_aliases_its_operand():
    # two rows written into a (256, 256) cache in place: no fresh (N,N)
    # temporary, and traffic is the touched strip, not N^2
    def f(c, st):
        c[torch.tensor([3, 9])] = st
        return c

    s = _summary(f, torch.zeros(256, 256), torch.ones(2, 256))
    assert s.temp_bytes < 256 * 256 * 4 * 0.1
    assert s.bytes < 256 * 256 * 4


def test_broadcast_is_regenerable_but_an_escaping_one_counts():
    x = torch.zeros(8, 8)
    internal = graphlib.trace(lambda v: (v[0].expand(8, 8) + v).sum(), x,
                              fake=True, functional=False)
    assert interp.find_blowups(internal, ratio=4.0, floor_bytes=1) == []
    escaping = graphlib.trace(lambda v: v.expand(1000, 8, 8), x, fake=True,
                              functional=False)
    found = interp.find_blowups(escaping, ratio=32.0, floor_bytes=4096)
    assert found and found[0].ratio > 500


def test_fit_exponent_recovers_power_laws():
    xs = (64, 128, 256, 512)
    assert interp.fit_exponent(xs, [4 * x * x for x in xs]) == \
        pytest.approx(2.0, abs=1e-6)
    assert model.leading_exponent(xs, [7 * x for x in xs]) == \
        pytest.approx(1.0, abs=1e-6)
    with pytest.raises(ValueError):
        interp.fit_exponent((64,), (1.0,))


# --------------------------------------------------------------------------
# entries, closed-form counts and the reference's policy
# --------------------------------------------------------------------------

def test_every_entry_traces_and_prices(ctx):
    table = model.cost_table(ctx)
    assert set(table) == set(entries.entry_names())
    assert {f"cohort_step[{f}]" for f in ("mlp-s", "mlp-m", "mlp-l",
                                          "resnet", "transformer", "ssm",
                                          "rglru")} <= set(table)
    for name, s in table.items():
        assert s.flops > 0 and s.bytes > 0, name
        assert s.peak_bytes >= s.temp_bytes, name


def test_trace_entry_rejects_unknowns():
    with pytest.raises(KeyError, match="unknown cost entry"):
        entries.trace_entry("no-such-entry")
    with pytest.raises(KeyError, match="unknown dims"):
        entries.trace_entry("divergence_matrix", nn=7)


def test_divergence_matmul_flops_are_the_closed_form(ctx):
    """At the budget dims the Eq. 2 product is 2·n²·(r·c) FLOPs exactly;
    with the row terms and exps the whole rebuild is the reference's
    694,272 (its ``entries.divergence_matrix.flops``)."""
    d = entries.DEFAULT_DIMS
    n, r, c = d["n"], d["r"], d["c"]
    s = model.cost_table(ctx)["divergence_matrix"]
    assert s.matmul_flops == 2 * n * n * r * c == 655_360
    assert s.flops == REF_BUDGETS["entries"]["divergence_matrix"]["flops"]


def test_leading_exponents_lie_under_the_references_ceilings(ctx):
    scaling = model.scaling_report(ctx)
    ceilings = REF_BUDGETS["exponents"]
    assert set(scaling) == set(ceilings)
    for name, ceiling in ceilings.items():
        assert scaling[name]["temp_bytes"]["leading"] <= ceiling, name
    # the Θ(u·N) pin holds while the full rebuild is Θ(N²)
    assert scaling["sqmd.build_graph_delta"]["temp_bytes"]["leading"] <= 1.2
    assert scaling["divergence_matrix"]["temp_bytes"]["leading"] >= 1.8
    assert scaling["divergence_matrix"]["flops"]["leading"] == \
        pytest.approx(2.0, abs=0.1)


def test_checked_in_budgets_keep_the_references_policy():
    ours = rules.load_budgets()
    assert set(ours["entries"]) == set(entries.entry_names())
    assert ours["dims"] == REF_BUDGETS["dims"] == entries.DEFAULT_DIMS
    assert ours["exponents"] == REF_BUDGETS["exponents"]
    assert ours["kernels"] == REF_BUDGETS["kernels"]
    assert ours["tolerance"] == REF_BUDGETS["tolerance"]
    assert ours["flop_counter_band"] == REF_BUDGETS["hlo_flops_band"]
    ref_blowup, blowup = REF_BUDGETS["blowup"], ours["blowup"]
    assert (blowup["ratio"], blowup["floor_bytes"]) == \
        (ref_blowup["ratio"], ref_blowup["floor_bytes"])
    assert set(blowup["allow"]) == set(ref_blowup["allow"])
    for name, prims in ref_blowup["allow"].items():
        assert blowup["allow"][name] == [
            op for p in prims for op in rules.ALLOW_MAP[p]], name


# --------------------------------------------------------------------------
# each cost rule on a seeded bug
# --------------------------------------------------------------------------

def test_superlinear_memory_fires_on_an_nn_temporary_in_the_delta_path(ctx):
    """The seeded bug: the delta path 'updated' by a dense rebuild, whose
    (N,N) cross term is a fresh temporary."""
    from repro_torch.core import similarity

    def mutant(cache, repo_logp):
        return cache + similarity.divergence_matrix(repo_logp)

    xs = (256, 512, 1024, 2048)
    ys = [_summary(mutant, torch.zeros(n, n), torch.zeros(n, 8, 10))
          .temp_bytes for n in xs]
    rec = {"sqmd.build_graph_delta": {
        "axis": "n", "values": list(xs),
        "temp_bytes": {"leading": model.leading_exponent(xs, ys),
                       "fit": interp.fit_exponent(xs, ys), "samples": ys}}}
    v = rules.exponent_violations(rec, {"sqmd.build_graph_delta": 1.2})
    assert len(v) == 1 and v[0].rule == "superlinear-memory"
    assert "Θ(n^2" in v[0].message
    assert rules.exponent_violations(model.scaling_report(ctx),
                                     {"sqmd.build_graph_delta": 1.2}) == []


def test_broadcast_blowup_fires_on_a_1000x_mutant_silent_on_real(ctx):
    gm = graphlib.trace(lambda w: w[:, None].expand(64, 1000),
                        torch.zeros(64), fake=True, functional=False)
    found = interp.find_blowups(gm, model.SCAN_RATIO, model.SCAN_FLOOR)
    v = rules.blowup_violations("mutant", found, rules._POLICY_BLOWUP)
    assert v and v[0].rule == "broadcast-blowup"
    allowed = {"allow": {"mutant": ["expand"]}, "ratio": 32.0,
               "floor_bytes": 4096}
    assert rules.blowup_violations("mutant", found, allowed) == []
    for name, cands in model.blowup_candidates(ctx).items():
        assert rules.blowup_violations(
            name, cands, rules.load_budgets()["blowup"]) == [], name


def test_cost_budget_fires_on_regression_inflation_and_missing(ctx):
    table = model.cost_table(ctx)
    real = rules.compute_budgets(ctx)
    assert rules.budget_violations(table, real) == []
    shrunk = json.loads(json.dumps(real))
    shrunk["entries"]["divergence_matrix"]["flops"] /= 2      # regression
    inflated = json.loads(json.dumps(real))
    inflated["entries"]["cohort_step"]["bytes"] *= 3          # stale budget
    v = rules.budget_violations(table, shrunk)
    assert [x.where for x in v] == ["divergence_matrix#flops"]
    assert "exceeds budget" in v[0].message
    v = rules.budget_violations(table, inflated)
    assert [x.where for x in v] == ["cohort_step#bytes"]
    assert "fell below budget" in v[0].message
    gone = json.loads(json.dumps(real))
    del gone["entries"]["serve_step"]
    gone["entries"]["vanished_entry"] = {"flops": 1.0}
    where = {x.where: x.message for x in rules.budget_violations(table,
                                                                  gone)}
    assert "no budget" in where["serve_step"]
    assert "no longer traced" in where["vanished_entry"]


def test_kernel_intensity_holds_the_model_to_flop_counter_mode():
    """Each kernel's plain version: the model's matmul FLOPs equal
    FlopCounterMode's on the same call, and its intensity clears the
    reference's floor."""
    floors = REF_BUDGETS["kernels"]
    probes = rules.kernel_probes()
    assert set(probes) == set(floors)
    for name, (fn, args) in probes.items():
        summary, counted = rules.kernel_cost(fn, args)
        assert summary.matmul_flops == counted, name
        assert rules.intensity_violations(
            name, summary, floors[name]["intensity_floor"], counted) == []


def test_kernel_intensity_fires_on_a_defused_kernel_and_a_bad_count():
    from repro_torch.kernels import ref
    d = entries.DEFAULT_DIMS
    lp = torch.log_softmax(torch.randn(d["n"], d["r"], d["c"]), -1)

    def defused(logp):
        # the split planes of both operands round-trip through memory
        k = d["r"] * d["c"]
        return (ref.pairwise_kl_ref(logp),
                ref.pairwise_kl_split_ref(logp, True, k)[0],
                ref.pairwise_kl_split_ref(logp, False, k)[0])

    summary, counted = rules.kernel_cost(defused, (lp,))
    floor = REF_BUDGETS["kernels"]["pairwise_kl"]["intensity_floor"]
    v = rules.intensity_violations("pairwise_kl", summary, floor, counted)
    assert [x.where for x in v] == ["kernel.pairwise_kl"]
    v = rules.intensity_violations("pairwise_kl", summary, 0.0,
                                   counted * 10)
    assert [x.where for x in v] == ["kernel.pairwise_kl#flop-counter"]


# --------------------------------------------------------------------------
# budgets io and the gate
# --------------------------------------------------------------------------

def test_write_budgets_preserves_policy_sections(tmp_path, ctx):
    path = tmp_path / "budgets.json"
    path.write_text(json.dumps({"tolerance": 0.5,
                                "exponents": {"divergence_matrix": 2.5},
                                "blowup": {"ratio": 64.0,
                                           "floor_bytes": 8192,
                                           "allow": {}}}))
    out = rules.write_budgets(path, ctx)
    again = json.loads(path.read_text())
    assert again == json.loads(json.dumps(out))
    assert again["tolerance"] == 0.5
    assert again["exponents"]["divergence_matrix"] == 2.5
    assert again["exponents"]["sqmd.build_graph_delta"] == 1.2
    assert again["blowup"]["ratio"] == 64.0
    assert set(again["entries"]) == set(entries.entry_names())
    with pytest.raises(FileNotFoundError):
        rules.load_budgets(tmp_path / "missing.json")


def test_cli_write_budgets_and_cost_table(tmp_path, ctx, monkeypatch,
                                          capsys):
    # the CLI's own context would price everything again: hand it this
    # module's table
    table, scaling = model.cost_table(ctx), model.scaling_report(ctx)
    monkeypatch.setattr(model, "cost_table", lambda c=None, dims=None: table)
    monkeypatch.setattr(model, "scaling_report", lambda c=None: scaling)
    path = tmp_path / "b.json"
    assert analyze.main(["--device", "cpu", "--write-budgets",
                         str(path)]) == 0
    written = json.loads(path.read_text())
    assert written["entries"]["divergence_matrix"]["flops"] == 694_272.0
    assert written["exponents"] == REF_BUDGETS["exponents"]
    assert analyze.main(["--device", "cpu", "--cost-table"]) == 0
    out = capsys.readouterr().out
    assert "divergence_matrix" in out and "temp_bytes~n^" in out


def test_the_gate_is_clean_on_the_port(ctx):
    """Every family with an empty baseline on the CPU: no violation, no
    error; only a rule that needs the card may skip."""
    results = run_rules(ctx)
    assert len(results) == 15
    bad = [(r.rule, r.status, r.detail[-800:],
            [v.as_dict() for v in r.violations])
           for r in results if r.failed]
    assert not bad, bad
    assert all(r.status == "ok" or get_rule(r.rule).requires_cuda
               for r in results)
