"""The port's static-analysis gate (``repro_torch.analysis``): every rule
fires on a seeded bug and stays silent on the port's real entry points,
the lints agree with the reference's on both trees, and the registry,
runner, baseline and CLI behave as the reference's do.

A rule that never fires is worse than no rule: it certifies bugs as
passing. Everything runs on the CPU at the probe dims; the placement
rules run on an 8-entry CPU mesh.
"""
import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.analysis  # noqa: F401  (registers the rules)
from repro_torch.analysis import (fixtures, graph_rules, graphlib,
                                  launch_rules, lint_rules, placement_rules)
from repro_torch.analysis.registry import (AnalysisContext, Violation,
                                           get_rule, load_baseline,
                                           register_rule, registered_rules,
                                           rules_for, run_rules,
                                           unregister_rule, write_baseline)
from repro_torch.kernels import build
from repro_torch.kernels import pairwise_kl as pk
from repro_torch.kernels.geometry import Cover, Geometry, TensorMap
from repro_torch.launch import analyze

REPO = Path(__file__).resolve().parent.parent

# the reference's rule names and the port's (registry docstring)
RULE_MAP = {
    "prng-key-reuse": "prng-key-reuse",
    "padded-shape-key-draw": "padded-shape-key-draw",
    "unmasked-optimizer-leaf": "unmasked-optimizer-leaf",
    "fp32-downcast-outside-codec": "fp32-downcast-outside-codec",
    "client-axis-collectives": "client-axis-collectives",
    "jit-cache-bucketing": "jit-cache-bucketing",
    "serve-jit-bucketing": "serve-jit-bucketing",
    "pallas-grid-divisibility": "launch-geometry",
    "bare-assert": "bare-assert",
    "literal-interpret-default": "literal-device-default",
    "unregistered-registry-name": "unregistered-registry-name",
    "cost-budget": "cost-budget",
    "broadcast-blowup": "broadcast-blowup",
    "superlinear-memory": "superlinear-memory",
    "kernel-intensity": "kernel-intensity",
}


@pytest.fixture(scope="module")
def ctx():
    return AnalysisContext(device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# --------------------------------------------------------------------------
# prng-key-reuse
# --------------------------------------------------------------------------

def _equal_seeded_draws():
    a = torch.randn((3,), generator=_gen(5))
    b = torch.rand((3,), generator=_gen(5))         # the same stream again
    return a + b


def test_key_reuse_fires_on_equal_seeded_generators():
    v = graph_rules.audit_key_reuse("bad",
                                    graphlib.spy_draws(_equal_seeded_draws))
    assert len(v) == 1 and v[0].rule == "prng-key-reuse"
    assert "one stream state" in v[0].message


def test_key_reuse_fires_on_the_global_generator():
    v = graph_rules.audit_key_reuse(
        "bad", graphlib.spy_draws(lambda: torch.randint(0, 5, (4,))))
    assert v and "process-global" in v[0].message


def test_key_reuse_silent_on_an_advancing_generator_and_real_entries(ctx):
    def good():
        g = _gen(5)
        return torch.randn((3,), generator=g) + torch.rand((3,), generator=g)

    assert graph_rules.audit_key_reuse("good", graphlib.spy_draws(good)) \
        == []
    entries = fixtures.build_entries(ctx)
    for name in ("cohort_batch", "cohort_batch_padded"):
        assert len(entries[name].draws) == 1
        assert graph_rules.audit_key_reuse(name, entries[name].draws) == []


# --------------------------------------------------------------------------
# padded-shape-key-draw
# --------------------------------------------------------------------------

def _draw_at_padded_rows():
    # the batch indices drawn at the PADDED row count
    return torch.randint(0, fixtures.SAMPLES,
                         (fixtures.N_ROWS, fixtures.BATCH),
                         generator=_gen(3))


def test_padded_draw_fires_on_a_draw_at_the_padded_rows():
    v = graph_rules.audit_padded_draws(
        "mutant", graphlib.spy_draws(_draw_at_padded_rows),
        (fixtures.N_ROWS, fixtures.N_REAL))
    assert v and v[0].rule == "padded-shape-key-draw"


def test_padded_draw_silent_on_the_real_padded_pipeline(ctx):
    entry = fixtures.build_entries(ctx)["cohort_batch_padded"]
    assert entry.padded == (fixtures.N_ROWS, fixtures.N_REAL)
    assert entry.draws[0].shape == (fixtures.N_REAL, fixtures.BATCH)
    assert graph_rules.audit_padded_draws(
        "cohort_batch_padded", entry.draws, entry.padded) == []


# --------------------------------------------------------------------------
# unmasked-optimizer-leaf
# --------------------------------------------------------------------------

def _mask_probe_args():
    params = [torch.ones((3, 3)), torch.zeros((3,))]
    moments = [torch.zeros((3, 3)), torch.zeros((3, 3))]
    return params, moments, torch.ones((3,), dtype=torch.bool)


def _gated(on, new, old):
    return torch.where(on.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _ungated_moment(params, moments, gate):
    new_p = [_gated(gate, p - 0.1, p) for p in params]
    new_m = [0.9 * m + 0.1 for m in moments]               # never gated
    return new_p, new_m


def test_masked_update_fires_on_an_ungated_adam_moment():
    v = graph_rules.audit_masked_update(
        _ungated_moment, _mask_probe_args(), [2, 2, 1], gate_arg=2,
        checked_args=(0, 1), where="mutant",
        arg_names=("params", "opt_state", "gate"))
    # exactly the two moments escape the freeze
    assert len(v) == 2
    assert all("opt_state" in x.where for x in v)
    assert all(x.rule == "unmasked-optimizer-leaf" for x in v)


def test_masked_update_silent_when_every_tensor_is_gated():
    def good(params, moments, gate):
        return ([_gated(gate, p - 0.1, p) for p in params],
                [_gated(gate, 0.9 * m + 0.1, m) for m in moments])

    assert graph_rules.audit_masked_update(
        good, _mask_probe_args(), [2, 2, 1], gate_arg=2,
        checked_args=(0, 1), where="good") == []


def test_masked_update_silent_on_the_real_cohort_step_and_checks_counts():
    wrapper, make_args, counts, names = fixtures.cohort_step_probe()
    # Adam's state: the per-client step counter and two moments a param
    assert counts[:2] == [4, 9]
    assert graph_rules.audit_masked_update(
        wrapper, make_args(), counts, gate_arg=6, checked_args=(0, 1),
        where="cohort_step", arg_names=names) == []
    with pytest.raises(ValueError, match="leaf_counts"):
        graph_rules.audit_masked_update(
            wrapper, make_args(), counts[:-1] + [counts[-1] + 1],
            gate_arg=6, checked_args=(0,), where="x")


def test_functional_trace_turns_in_place_writes_into_outputs():
    """``cohort_step`` writes its params in place (``p.copy_``); the
    functionalized graph returns the new values, each a ``where`` on the
    trainable mask, and no in-place op is left before the copy-backs."""
    wrapper, make_args, counts, _ = fixtures.cohort_step_probe()
    gm = graphlib.trace(wrapper, *make_args())
    outs = graphlib.output_nodes(gm)
    deps = graphlib.output_dependencies(gm)
    gate = sum(counts[:6])
    assert all(gate in d for d in deps[:counts[0] + counts[1]])
    assert all(o.target is torch.ops.aten.copy.default
               for o in outs[:counts[0]])


# --------------------------------------------------------------------------
# fp32-downcast-outside-codec
# --------------------------------------------------------------------------

def _bf16_cast(t):
    return t.to(torch.bfloat16) + 1


def test_downcast_fires_on_a_bf16_cast_and_int8_quantization():
    x = torch.ones((4,))
    v = graph_rules.audit_downcasts("mutant", graphlib.trace(_bf16_cast, x))
    assert v and "float32 -> bfloat16" in v[0].message
    assert graph_rules.audit_downcasts(
        "mutant", graphlib.trace(lambda t: (t * 127).to(torch.int8), x))


def test_downcast_silent_on_fp32_and_the_real_step(ctx):
    gm = graphlib.trace(lambda t: t * 2.0, torch.ones((4,)))
    assert graph_rules.audit_downcasts("clean", gm) == []
    entry = fixtures.build_entries(ctx)["cohort_step"]
    assert graph_rules.audit_downcasts("cohort_step", entry.graph) == []


def test_downcast_codec_boundary_is_exempt(ctx):
    entries = fixtures.build_entries(ctx)
    entry = entries["wire[int8].roundtrip"]
    assert entry.codec_boundary
    assert graphlib.find_downcasts(entry.graph)     # quantization happens
    assert not any(e.codec_boundary for n, e in entries.items()
                   if not n.startswith("wire[")
                   and n != "cohort_messenger_upload[int8]")


# --------------------------------------------------------------------------
# client-axis-collectives (shard isolation)
# --------------------------------------------------------------------------

def _neighbour_rows_step(coh, idx, ref_x, targets, trainable, rho,
                         use_ref):
    # each shard's targets shifted a row: shard k reads shard k+1's first
    # row at its boundary
    from repro_torch.core.client import sharded_cohort_step
    sharded_cohort_step(coh, idx, ref_x, targets.roll(-1, 0), trainable,
                        rho, use_ref)


def test_isolation_fires_on_a_shard_reading_its_neighbours_rows():
    v = placement_rules.step_isolation(_neighbour_rows_step, device="cpu")
    assert v and all(x.rule == "client-axis-collectives" for x in v)
    pairs = [tuple(map(int, re.findall(r"shard(\d+)", x.where)))
             for x in v]
    assert all(j == k + 1 for k, j in pairs) and len(pairs) >= 5


def test_isolation_fires_on_a_strip_reading_the_next_block():
    from repro_torch.core import similarity
    from repro_torch.kernels import ops

    def mutant(logp, mesh):
        n = logp.shape[0]
        rows = -(-n // mesh.size)
        padded = torch.cat([logp, logp[-1:].expand(rows * mesh.size - n,
                                                   *logp.shape[1:])])
        strips = [ops.pairwise_kl_pair(
            padded[((i + 1) % mesh.size) * rows:][:rows], logp)
            for i in range(mesh.size)]
        return torch.cat(strips)[:n]

    v = placement_rules.divergence_isolation(mutant, device="cpu")
    assert v and "strip0" in v[0].where
    assert placement_rules.divergence_isolation(
        similarity.divergence_matrix, device="cpu") == []


def test_isolation_silent_on_the_real_sharded_paths():
    assert placement_rules.step_isolation(device="cpu") == []
    assert placement_rules.upload_isolation(device="cpu") == []


# --------------------------------------------------------------------------
# jit-cache-bucketing / serve-jit-bucketing
# --------------------------------------------------------------------------

def test_bucketing_fires_on_a_delta_update_without_bucket_rows(monkeypatch):
    from repro_torch.core import similarity
    sigs = placement_rules.delta_signatures(device="cpu")
    assert placement_rules.bucket_violations(
        "update_divergence_cache", sigs, placement_rules.REPLAY_BUCKETS) \
        == []
    assert len(set(sigs)) == 4
    monkeypatch.setattr(similarity, "_bucket_rows", lambda rows: rows)
    v = placement_rules.bucket_violations(
        "update_divergence_cache", placement_rules.delta_signatures(
            device="cpu"), placement_rules.REPLAY_BUCKETS)
    assert v and v[0].rule == "jit-cache-bucketing"
    assert "6 distinct shapes" in v[0].message


def test_serve_bucketing_fires_without_pow2_buckets(monkeypatch):
    from repro_torch.serve import engine
    sigs = placement_rules.serve_signatures(device="cpu")
    assert sorted({s[0] for s in sigs}) == [1, 2, 4, 8, 16]
    monkeypatch.setattr(engine, "bucket_size", lambda n, floor=1: n)
    v = placement_rules.bucket_violations(
        "serve", placement_rules.serve_signatures(device="cpu"), 5,
        rule="serve-jit-bucketing")
    assert v and v[0].rule == "serve-jit-bucketing"


# --------------------------------------------------------------------------
# launch-geometry
# --------------------------------------------------------------------------

def _short(geo: Geometry, axis: int) -> Geometry:
    grid = list(geo.grid)
    grid[axis] -= 1
    return Geometry(geo.kernel, tuple(grid), geo.block, geo.smem, geo.covers,
                    geo.tensor_maps)


def test_geometry_fires_on_a_grid_one_tile_short():
    geo = pk.gemm_geometry(131, 257, 32)
    assert launch_rules.check_geometry("probe", geo) == []
    v = launch_rules.check_geometry("probe", _short(geo, 0))
    assert len(v) == 1 and "out cols (M)" in v[0].where
    assert "never computed" in v[0].message


def test_geometry_fires_on_an_idle_block_smem_and_tma_strides():
    idle = Geometry("k", (3, 1, 1), (256, 1, 1), 0,
                    (Cover("rows", 0, 8, 16),))
    assert "wholly outside" in launch_rules.check_geometry("p", idle)[0] \
        .message
    big = Geometry("k", (1, 1, 1), (256, 1, 1), 228 * 1024,
                   (Cover("rows", 0, 8, 8),))
    assert "#smem" in launch_rules.check_geometry("p", big)[0].where
    tma = Geometry("k", (1, 1, 1), (384, 1, 1), 0, (),
                   (TensorMap("a_hi", (21, 131), (84,)),))
    v = launch_rules.check_geometry("p", tma)
    assert v and "multiples of 16" in v[0].message


def test_thin_geometry_strides_past_the_resident_cap():
    from repro_torch.kernels import dequant_kl as dk
    geo = dk.thin_geometry(9, 100_003, 3, 7, False, 132, 1)
    assert geo.grid[0] == 132 and geo.covers[0].passes > 1
    assert launch_rules.check_geometry("p", geo) == []
    # a persistent grid strides: one block fewer is one more pass
    assert launch_rules.check_geometry("p", _short(geo, 0)) == []


def test_every_probe_geometry_is_clean_and_every_kernel_is_probed():
    probes = launch_rules.probe_geometries()
    assert {g.kernel for _, g in probes} == {
        "pairwise_kl_split", "pairwise_kl_pair", "neighbor_mean_split",
        "soft_ce", "neighbor_gather", "int8_pairwise_kl_split",
        "int8_pairwise_kl_thin", "ragged_dot", "ragged_dot_wgrad",
        "ragged_dot_tma", "ragged_dot_wgrad_tma", "ragged_dot_tf32",
        "ragged_dot_wgrad_tf32_split", "ragged_dot_wgrad_tf32"}
    for label, geo in probes:
        assert launch_rules.check_geometry(label, geo) == [], label


def _constexpr(src: str, name: str) -> int:
    m = re.search(r"constexpr (?:int|uint32_t) " + name + r" = ([^;]+);",
                  src)
    assert m is not None, name
    return m.group(1)


def test_python_launch_constants_are_the_sources():
    """The geometry functions restate each source's block constants; the
    entry points refuse any other launch, so the two must agree."""
    from repro_torch.kernels import dequant_kl as dk
    from repro_torch.kernels import neighbor_gather as ng
    from repro_torch.kernels import neighbor_mean as nm
    from repro_torch.kernels import soft_ce as sc

    def src(name):
        return (build.CSRC / f"{name}.cu").read_text()

    pks = src("pairwise_kl")
    assert int(_constexpr(pks, "SPLIT_ROWS")) == pk.SPLIT_ROWS
    assert int(_constexpr(pks, "BM")) == pk.BM
    assert int(_constexpr(pks, "BN")) == pk.BN
    assert int(_constexpr(pks, "BK")) == pk.BK
    assert _constexpr(pks, "THREADS") == "128 * (1 + CONSUMERS)"
    assert int(_constexpr(pks, "CONSUMERS")) == pk.GEMM_THREADS // 128 - 1
    assert int(_constexpr(pks, "STAGES")) * 4 * pk.BM * pk.BK * 4 + 1024 \
        == pk.GEMM_SMEM
    assert int(_constexpr(src("soft_ce"), "THREADS")) == sc.THREADS
    assert int(_constexpr(src("neighbor_gather"), "THREADS")) == ng.THREADS
    nms = src("neighbor_mean")
    assert (int(_constexpr(nms, "TN")), int(_constexpr(nms, "TJ")),
            int(_constexpr(nms, "THREADS"))) == (nm.TN, nm.TJ, nm.THREADS)
    dks = src("dequant_kl")
    assert int(_constexpr(dks, "WARPS")) == dk.WARPS
    assert int(_constexpr(dks, "THIN_ROWS")) == dk.THIN_ROWS


# --------------------------------------------------------------------------
# lint rules, and their parity with the reference's
# --------------------------------------------------------------------------

def _trees(root: Path):
    for path in sorted(root.rglob("*.py")):
        try:
            yield path, ast.parse(path.read_text())
        except SyntaxError:
            continue


@pytest.mark.parametrize("tree_root", ["src/repro", "src/repro_torch"])
def test_lint_functions_match_the_references_on_both_trees(tree_root):
    from repro.analysis import lint_rules as ref_lint
    root = REPO / tree_root
    regs = (ref_lint._live_registries() if tree_root == "src/repro"
            else lint_rules.live_registries())
    n = 0
    for path, tree in _trees(root):
        rel = str(path.relative_to(root))
        assert [v.key for v in lint_rules.find_bare_asserts(tree, rel)] == \
            [v.key for v in ref_lint.find_bare_asserts(tree, rel)], rel
        got = lint_rules.find_unregistered_names(tree, rel, regs)
        want = ref_lint.find_unregistered_names(tree, rel, regs)
        assert [v.key for v in got] == [v.key for v in want], rel
        n += 1
    assert n > 30


def test_bare_assert_fires_and_kernel_exemption():
    src = ("def f(x):\n"
           "    assert x > 0\n"
           "    return x\n"
           "def _kernel_body(ref):\n"
           "    assert ref.ndim == 2\n")
    v = lint_rules.find_bare_asserts(ast.parse(src), "m.py")
    assert len(v) == 1 and v[0].where == "m.py:2"


def test_literal_device_default_fires_on_cpu_defaults():
    src = ("import torch\n"
           "def serve(x, device='cpu'):\n"
           "    return x\n"
           "def train(x, *, device=torch.device('cpu')):\n"
           "    return x\n"
           "def _helper(x, device='cpu'):\n"
           "    return x\n"
           "def run(x, device=None):\n"
           "    return x\n")
    v = lint_rules.find_literal_device(ast.parse(src), "m.py")
    assert [x.where for x in v] == ["m.py:2", "m.py:4"]
    assert "literal CPU default" in v[0].message


def test_literal_device_default_fires_on_a_plain_fallback_in_kernels():
    src = ("def soft_ce(z, y):\n"
           "    try:\n"
           "        return launch(z, y)\n"
           "    except RuntimeError:\n"
           "        return plain(z, y)\n"
           "def other(z):\n"
           "    try:\n"
           "        return launch(z)\n"
           "    except RuntimeError:\n"
           "        raise\n")
    v = lint_rules.find_literal_device(ast.parse(src), "kernels/soft_ce.py")
    assert [x.where for x in v] == ["kernels/soft_ce.py:4"]
    assert lint_rules.find_literal_device(ast.parse(src), "core/x.py") == []


def test_unregistered_registry_name_and_spec_suffix():
    regs = lint_rules.live_registries()
    assert {"mlp-s", "resnet", "transformer", "ssm", "rglru"} \
        <= regs["get_family"] == regs["as_family"]
    assert set(RULE_MAP.values()) <= regs["get_rule"]
    src = ('a = get_policy("no-such-policy")\n'
           'b = as_codec("topk:4")\n'
           'c = as_codec("topk:0")\n'
           'd = as_batch_policy("micro:")\n'
           'e = get_family("mlp-xl")\n'
           'f = get_rule("launch-geometry")\n')
    by_line = {x.where: x.message for x in lint_rules.find_unregistered_names(
        ast.parse(src), "m.py", regs)}
    assert "names nothing registered" in by_line["m.py:1"]
    assert "m.py:2" not in by_line and "m.py:6" not in by_line
    assert "malformed spec suffix" in by_line["m.py:3"]
    assert "malformed spec suffix" in by_line["m.py:4"]
    assert "mlp-xl" in by_line["m.py:5"]


# --------------------------------------------------------------------------
# the rule set (the whole gate on the port is test_torch_cost_model's,
# which prices the cost family once)
# --------------------------------------------------------------------------

def test_every_reference_rule_has_its_port():
    assert set(registered_rules()) == set(RULE_MAP.values())
    fam = {n: get_rule(n).family for n in registered_rules()}
    assert fam["launch-geometry"] == "launch"
    assert fam["client-axis-collectives"] == "placement"
    assert fam["prng-key-reuse"] == "graph"


# --------------------------------------------------------------------------
# registry, runner, baseline, CLI
# --------------------------------------------------------------------------

def test_registry_rejects_duplicates_and_unknowns():
    @register_rule("tmp-test-rule", family="lint")
    def tmp_rule(ctx):
        return []

    try:
        with pytest.raises(ValueError, match="already registered"):
            register_rule("tmp-test-rule", family="lint")(lambda c: [])
    finally:
        unregister_rule("tmp-test-rule")
    with pytest.raises(ValueError, match="unknown rule family"):
        register_rule("tmp-test-rule2", family="jaxpr")(lambda c: [])
    with pytest.raises(KeyError, match="unknown rule"):
        get_rule("never-registered")
    with pytest.raises(ValueError, match="unknown rule family"):
        rules_for(families=["hlo"])
    with pytest.raises(ValueError, match="device"):
        AnalysisContext(device="tpu")


def test_runner_skips_below_the_device_floor_and_off_the_card():
    @register_rule("tmp-needs-devices", family="placement",
                   requires_devices=10_000)
    def needy(ctx):                        # pragma: no cover - skipped
        raise AssertionError("must not run")

    @register_rule("tmp-needs-card", family="launch", requires_cuda=True)
    def card(ctx):                         # pragma: no cover - skipped
        raise AssertionError("must not run")

    try:
        r1, r2 = run_rules(AnalysisContext(device="cpu"),
                           names=["tmp-needs-devices", "tmp-needs-card"])
        assert {r1.status, r2.status} == {"skipped"}
        assert not r1.failed and not r2.failed
        assert "--device cuda" in r1.detail or "--device cuda" in r2.detail
        assert any("10000 CUDA devices" in r.detail for r in (r1, r2))
    finally:
        unregister_rule("tmp-needs-devices")
        unregister_rule("tmp-needs-card")


def test_runner_turns_a_crash_into_an_error_and_the_cli_exits_1(capsys):
    @register_rule("tmp-crashes", family="lint")
    def crashes(ctx):
        raise RuntimeError("auditor exploded")

    try:
        (r,) = run_rules(AnalysisContext(device="cpu"),
                         names=["tmp-crashes"])
        assert r.status == "error" and r.failed
        assert "auditor exploded" in r.detail
        assert analyze.main(["--device", "cpu", "--rules",
                             "tmp-crashes"]) == 1
        assert "rule crashed" in capsys.readouterr().out
    finally:
        unregister_rule("tmp-crashes")


def _unbucketed_delta():
    """The delta update's strips without ``_bucket_rows``."""
    from repro_torch.core import similarity
    real = similarity._bucket_rows
    similarity._bucket_rows = lambda rows: rows
    try:
        return placement_rules.bucket_violations(
            "update_divergence_cache",
            placement_rules.delta_signatures(device="cpu"),
            placement_rules.REPLAY_BUCKETS)
    finally:
        similarity._bucket_rows = real


def _nn_temporary_in_the_delta_path():
    """The delta path 'updated' by a dense rebuild: its (N,N) cross term
    a fresh temporary, scaling as n^2 against the reference's 1.2."""
    from repro_torch.analysis.cost import interp, model, rules
    from repro_torch.core import similarity
    xs = (256, 512, 1024, 2048)
    ys = [interp.summary_of(
        lambda c, lp: c + similarity.divergence_matrix(lp),
        torch.zeros(n, n), torch.zeros(n, 8, 10)).temp_bytes for n in xs]
    rec = {"sqmd.build_graph_delta": {
        "axis": "n", "values": list(xs),
        "temp_bytes": {"leading": model.leading_exponent(xs, ys),
                       "samples": ys}}}
    return rules.exponent_violations(rec, {"sqmd.build_graph_delta": 1.2})


# each seeded bug of the tests above, as its rule's helper reports it
SEEDED = {
    "equal-seeded draws": lambda: graph_rules.audit_key_reuse(
        "seeded", graphlib.spy_draws(_equal_seeded_draws)),
    "draw at N_ROWS": lambda: graph_rules.audit_padded_draws(
        "seeded", graphlib.spy_draws(_draw_at_padded_rows),
        (fixtures.N_ROWS, fixtures.N_REAL)),
    "ungated moment": lambda: graph_rules.audit_masked_update(
        _ungated_moment, _mask_probe_args(), [2, 2, 1], gate_arg=2,
        checked_args=(0, 1), where="seeded"),
    "bf16 cast": lambda: graph_rules.audit_downcasts(
        "seeded", graphlib.trace(_bf16_cast, torch.ones((4,)))),
    "neighbour's rows": lambda: placement_rules.step_isolation(
        _neighbour_rows_step, device="cpu"),
    "no _bucket_rows": _unbucketed_delta,
    "one tile short": lambda: launch_rules.check_geometry(
        "seeded", _short(pk.gemm_geometry(131, 257, 32), 0)),
    "(N,N) temporary": _nn_temporary_in_the_delta_path,
}


@pytest.mark.parametrize("bug", sorted(SEEDED))
def test_a_seeded_bug_makes_the_cli_exit_1(bug, capsys):
    @register_rule("tmp-seeded", family="lint")
    def seeded(ctx):
        yield from SEEDED[bug]()

    try:
        assert analyze.main(["--device", "cpu", "--json", "--rules",
                             "tmp-seeded"]) == 1
        out = capsys.readouterr().out
        assert '"failed": true' in out and '"status": "violation"' in out
    finally:
        unregister_rule("tmp-seeded")


def test_the_cli_exits_0_on_clean_rules():
    assert analyze.main(["--device", "cpu", "--rules", "launch-geometry",
                         "bare-assert"]) == 0


def test_baseline_roundtrip_suppresses(tmp_path):
    @register_rule("tmp-finding", family="lint")
    def finding(ctx):
        yield Violation("tmp-finding", "somewhere", "a known issue")

    try:
        (r,) = run_rules(names=["tmp-finding"])
        assert r.status == "violation" and r.failed
        path = tmp_path / "baseline.json"
        assert write_baseline(path, [r]) == 1
        baseline = load_baseline(path)
        assert baseline == {"tmp-finding::somewhere"}
        (r2,) = run_rules(names=["tmp-finding"], baseline=baseline)
        assert r2.status == "ok" and r2.suppressed == 1
    finally:
        unregister_rule("tmp-finding")


def test_baseline_load_rejects_garbage(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_baseline(tmp_path / "missing.json")
    bad = tmp_path / "bad.json"
    bad.write_text('{"suppressed": 3}')
    with pytest.raises(ValueError, match="JSON list"):
        load_baseline(bad)


def test_cli_lists_every_rule_and_refuses_an_empty_selection(capsys):
    assert analyze.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("15 rule(s) in 5 family(ies)")
    for name in RULE_MAP.values():
        assert f"  {name}: " in out
    assert analyze.main(["--device", "cpu", "--rules", "nope"]) == 2
    assert analyze.main(["--device", "cpu", "--families", "jaxpr"]) == 2
    assert "unknown rule family" in capsys.readouterr().err


def test_placement_probes_use_the_given_device():
    mesh = placement_rules.probe_mesh("cpu")
    assert mesh.size == 8 and {d.type for d in mesh.devices} == {"cpu"}
    sigs = placement_rules.delta_signatures(device="cpu")
    assert all(isinstance(s, tuple) for s in sigs)
    assert np.array_equal(sorted({s[0][0] for s in sigs}), [1, 2, 4, 8])
