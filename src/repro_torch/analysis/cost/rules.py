"""The ``cost`` rule family: cost budgets as gates.

Four rules over the static cost model (``interp``/``entries``/``model``):

  cost-budget        — every entry's flops / bytes / temp_bytes within a
                       tolerance band of the checked-in
                       ``cost_budgets.json``. The band is TWO-sided: a
                       regression fails, and so does a cost that fell far
                       below its budget (an inflated budget would hide
                       the next regression inside its slack).
  broadcast-blowup   — no materialized op output more than ``ratio`` x
                       the size of all its inputs combined (fusion-aware;
                       generative fills exempt).
  superlinear-memory — the fitted leading exponent of each entry's
                       temporary-memory scaling stays within budget: the
                       rule that pins ``sqmd.build_graph_delta`` at
                       Θ(u·N).
  kernel-intensity   — arithmetic intensity of each hand kernel's work,
                       priced from its plain version
                       (``repro_torch.kernels.ref``), above a roofline
                       floor; the model's matmul FLOPs are held against
                       ``torch.utils.flop_counter.FlopCounterMode`` on the
                       same plain call with real CPU tensors (the
                       reference holds them against its compiled HLO).

Budgets are policy and baseline in one file: the ``entries`` section is
measured (re-baseline with ``launch/analyze.py --write-budgets``); the
``exponents`` / ``kernels`` / ``blowup`` sections are the reference's
hand-set policy, PRESERVED by a re-baseline.

Every rule body delegates to an audit helper that takes explicit inputs,
so the tests feed seeded-bug graphs and budgets through the same code the
gate runs.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.analysis.cost import entries as entries_mod
from repro_torch.analysis.cost import interp
from repro_torch.analysis.cost import model
from repro_torch.analysis.registry import (AnalysisContext, Violation,
                                           register_rule)

BUDGETS_PATH = Path(__file__).resolve().parent / "cost_budgets.json"

# policy: temp_bytes leading-exponent ceilings along each entry's scale
# axis, the reference's: 1.2 pins Θ(n) (the delta path's Θ(u·N)), 2.15
# lets the exact rebuilds be quadratic but no worse, 1.5 keeps the IVF
# search sub-quadratic
_POLICY_EXPONENTS: Dict[str, float] = {
    "cohort_step": 1.2,
    "cohort_messenger_upload": 1.2,
    "cohort_messenger_upload[int8]": 1.2,
    "sqmd.grade": 1.2,
    "sqmd.build_graph": 2.15,
    "sqmd.build_graph_delta": 1.2,
    "divergence_matrix": 2.15,
    "int8_dequant_kl": 2.15,
    "centroid_assign": 1.2,
    "ivf_search": 1.5,
    "serve_step": 1.2,
}


def _zoo_exponents() -> None:
    # every zoo family's cohort step stays Θ(n) in clients: no norm or
    # attention spans the client axis, so a cross-client (n, n, ·)
    # intermediate is a bug whatever the family
    from repro_torch.models.zoo import registered_families
    for fam in registered_families():
        _POLICY_EXPONENTS[f"cohort_step[{fam}]"] = 1.2


_zoo_exponents()

# policy: roofline intensity floors (flops a byte of arguments and
# result) of each kernel's work, the reference's
_POLICY_KERNELS: Dict[str, Dict[str, float]] = {
    "pairwise_kl": {"intensity_floor": 8.0},
    "pairwise_kl_pair": {"intensity_floor": 1.5},
    "int8_pairwise_kl": {"intensity_floor": 15.0},
    "soft_ce": {"intensity_floor": 1.0},
    "neighbor_mean": {"intensity_floor": 5.0},
}

# policy: the reference's blowup ratio and floor; its allow-list names
# jaxpr primitives, mapped to the aten ops that play their part:
# dot_general the batched and plain matmuls; pad both jnp.pad and the
# transpose of a slice (JAX differentiates a slice into a pad), which
# aten spells constant_pad_nd and slice_backward
ALLOW_MAP = {"dot_general": ["bmm", "mm", "addmm", "baddbmm"],
             "pad": ["constant_pad_nd", "slice_backward"]}
_POLICY_BLOWUP = {"ratio": 32.0, "floor_bytes": 4096, "allow": {
    "cohort_step[transformer]": ALLOW_MAP["dot_general"],
    "cohort_step[rglru]": ALLOW_MAP["dot_general"],
    "cohort_step[ssm]": ALLOW_MAP["dot_general"] + ALLOW_MAP["pad"],
}}
_DEFAULT_TOLERANCE = 0.35
_DEFAULT_FLOP_BAND = 3.0


# --------------------------------------------------------------------------
# budgets io
# --------------------------------------------------------------------------

def load_budgets(path: Optional[Path] = None) -> dict:
    p = Path(path) if path else BUDGETS_PATH
    if not p.exists():
        raise FileNotFoundError(
            f"cost budgets not found: {p}; generate them with "
            f"launch/analyze.py --write-budgets")
    return json.loads(p.read_text())


def compute_budgets(ctx: Optional[AnalysisContext] = None,
                    existing: Optional[dict] = None) -> dict:
    """Fresh budgets: measured ``entries`` scalars plus the policy
    sections kept from ``existing`` (or the defaults for a first
    write)."""
    table = model.cost_table(ctx)
    old = existing or {}
    return {
        "dims": dict(entries_mod.DEFAULT_DIMS),
        "tolerance": old.get("tolerance", _DEFAULT_TOLERANCE),
        "entries": {name: {m: getattr(s, m) for m in model.METRICS}
                    for name, s in sorted(table.items())},
        # hand-set values in an existing file win a key at a time, but an
        # entry new to the code still picks up its policy default
        "exponents": {**_POLICY_EXPONENTS, **old.get("exponents", {})},
        "kernels": {**_POLICY_KERNELS, **old.get("kernels", {})},
        "blowup": old.get("blowup", dict(_POLICY_BLOWUP)),
        "flop_counter_band": old.get("flop_counter_band",
                                     _DEFAULT_FLOP_BAND),
    }


def write_budgets(path: Optional[Path] = None,
                  ctx: Optional[AnalysisContext] = None) -> dict:
    """(Re-)baseline the measured section; returns what was written."""
    p = Path(path) if path else BUDGETS_PATH
    existing = json.loads(p.read_text()) if p.exists() else None
    budgets = compute_budgets(ctx, existing=existing)
    p.write_text(json.dumps(budgets, indent=2, sort_keys=True) + "\n")
    return budgets


def _ctx_budgets(ctx: AnalysisContext) -> dict:
    if "cost_budgets" not in ctx.cache:
        ctx.cache["cost_budgets"] = load_budgets()
    return ctx.cache["cost_budgets"]  # type: ignore[return-value]


# --------------------------------------------------------------------------
# audit helpers (explicit inputs, no registry state)
# --------------------------------------------------------------------------

def budget_violations(table: Dict[str, interp.CostSummary], budgets: dict,
                      rule: str = "cost-budget") -> List[Violation]:
    tol = float(budgets.get("tolerance", _DEFAULT_TOLERANCE))
    out: List[Violation] = []
    for name in sorted(budgets.get("entries", {})):
        per = budgets["entries"][name]
        s = table.get(name)
        if s is None:
            out.append(Violation(rule, name,
                                 "budgeted entry no longer traced: drop it "
                                 "with --write-budgets or restore the entry "
                                 "point"))
            continue
        for metric, budget in sorted(per.items()):
            val = float(getattr(s, metric))
            b = float(budget)
            if val > b * (1.0 + tol):
                out.append(Violation(
                    rule, f"{name}#{metric}",
                    f"{metric} {val:.3e} exceeds budget {b:.3e} "
                    f"(+{100 * (val / b - 1):.0f}%, band ±{tol:.0%}): a "
                    f"cost regression, or re-baseline with "
                    f"--write-budgets"))
            elif b and val < b * (1.0 - tol):
                out.append(Violation(
                    rule, f"{name}#{metric}",
                    f"{metric} {val:.3e} fell below budget {b:.3e} "
                    f"(-{100 * (1 - val / b):.0f}%, band ±{tol:.0%}): the "
                    f"budget is stale and would mask the next regression; "
                    f"re-baseline with --write-budgets"))
    for name in sorted(set(table) - set(budgets.get("entries", {}))):
        out.append(Violation(rule, name,
                             "entry traced but has no budget: add it with "
                             "--write-budgets"))
    return out


def exponent_violations(scaling: Dict[str, dict],
                        exponents: Dict[str, float],
                        rule: str = "superlinear-memory") -> List[Violation]:
    out: List[Violation] = []
    for name in sorted(exponents):
        ceiling = float(exponents[name])
        rec = scaling.get(name)
        if rec is None:
            out.append(Violation(rule, name,
                                 "exponent-budgeted entry has no scaling "
                                 "sweep (SCALE_AXES)"))
            continue
        got = float(rec["temp_bytes"]["leading"])
        if got > ceiling:
            axis = rec["axis"]
            out.append(Violation(
                rule, name,
                f"temporary-memory scaling fitted Θ({axis}^{got:.2f}) "
                f"exceeds the budgeted Θ({axis}^{ceiling:.2f}): samples "
                f"{['%.3e' % y for y in rec['temp_bytes']['samples']]} at "
                f"{axis}={rec['values']}"))
    return out


def blowup_violations(name: str, found: List[interp.Blowup], blowup: dict,
                      rule: str = "broadcast-blowup") -> List[Violation]:
    """The candidates of one entry (``interp.find_blowups``) that break
    the policy: above its ratio and floor, not on its allow-list."""
    allow = set(blowup.get("allow", {}).get(name, ()))
    ratio = float(blowup.get("ratio", 32.0))
    floor = int(blowup.get("floor_bytes", 4096))
    return [Violation(
        rule, f"{name}#{b.op}",
        f"{b.op} materializes {b.out_nbytes} bytes from {b.ratio:.0f}x "
        f"smaller inputs: {b.text}") for b in found
        if b.op not in allow and b.ratio > ratio and b.out_nbytes >= floor]


def intensity_violations(name: str, summary: interp.CostSummary,
                         floor: float,
                         counted_flops: Optional[float] = None,
                         band: float = _DEFAULT_FLOP_BAND,
                         rule: str = "kernel-intensity") -> List[Violation]:
    out: List[Violation] = []
    got = summary.intensity
    if got < floor:
        out.append(Violation(
            rule, f"kernel.{name}",
            f"arithmetic intensity {got:.2f} flops/byte below the roofline "
            f"floor {floor:.2f}: the kernel's work lost compute density "
            f"(extra memory round trips?)"))
    model_mm = summary.matmul_flops
    if counted_flops and model_mm:
        ratio = max(counted_flops / model_mm, model_mm / counted_flops)
        if ratio > band:
            out.append(Violation(
                rule, f"kernel.{name}#flop-counter",
                f"cost-model matmul FLOPs {model_mm:.3e} vs FlopCounterMode "
                f"{counted_flops:.3e} disagree by {ratio:.1f}x (band "
                f"{band:.1f}x): the model no longer prices what runs"))
    return out


# --------------------------------------------------------------------------
# kernel probes for kernel-intensity
# --------------------------------------------------------------------------

def kernel_probes() -> Dict[str, Tuple[Callable, tuple]]:
    """Kernel name -> (its plain version, real CPU arguments) at the
    reference dims. The plain version defines each kernel's math: its
    trace prices the kernel's work, the same function under
    ``FlopCounterMode`` is the cross-check."""
    from repro_torch.kernels import ref
    d = entries_mod.DEFAULT_DIMS
    n, r, c, u = d["n"], d["r"], d["c"], d["q"]
    g = torch.Generator().manual_seed(0)

    def logp(*shape):
        return torch.log_softmax(torch.randn(shape, generator=g), -1)

    return {
        "pairwise_kl": (ref.pairwise_kl_ref, (logp(n, r, c),)),
        "pairwise_kl_pair": (ref.pairwise_kl_pair_ref,
                             (logp(u, r, c), logp(n, r, c))),
        "int8_pairwise_kl": (ref.int8_pairwise_kl_ref, (
            torch.randint(0, 256, (n, r, c), dtype=torch.uint8,
                          generator=g),
            torch.full((n, r), 0.05), torch.zeros((n, r)))),
        "soft_ce": (ref.soft_ce_ref,
                    (logp(n, r, c), torch.zeros((r,), dtype=torch.int32))),
        "neighbor_mean": (ref.neighbor_mean_ref,
                          (torch.full((n, n), 1.0 / n),
                           torch.exp(logp(n, r, c)))),
    }


def kernel_cost(fn, args) -> Tuple[interp.CostSummary, float]:
    """(the cost model's summary of ``fn(*args)`` traced on fake
    tensors, FlopCounterMode's FLOPs of one real call)."""
    from torch.utils.flop_counter import FlopCounterMode
    summary = interp.summary_of(fn, *args)
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return summary, float(counter.get_total_flops())


# --------------------------------------------------------------------------
# registered rules
# --------------------------------------------------------------------------

@register_rule("cost-budget", family="cost")
def cost_budget(ctx: AnalysisContext) -> Iterable[Violation]:
    """Every entry's flops/bytes/temp_bytes within its budget band.

    Two-sided, against the checked-in cost_budgets.json."""
    yield from budget_violations(model.cost_table(ctx), _ctx_budgets(ctx))


@register_rule("broadcast-blowup", family="cost")
def broadcast_blowup(ctx: AnalysisContext) -> Iterable[Violation]:
    """No materialized intermediate vastly larger than its inputs.

    Fusion-aware; the allow-list is in the budgets."""
    blowup = _ctx_budgets(ctx).get("blowup", _POLICY_BLOWUP)
    if float(blowup.get("ratio", 32.0)) < model.SCAN_RATIO or \
            int(blowup.get("floor_bytes", 4096)) < model.SCAN_FLOOR:
        raise ValueError(f"the blowup policy {blowup} is looser than the "
                         f"scan ({model.SCAN_RATIO}x, "
                         f"{model.SCAN_FLOOR} bytes)")
    for name, found in sorted(model.blowup_candidates(ctx).items()):
        yield from blowup_violations(name, found, blowup)


@register_rule("superlinear-memory", family="cost")
def superlinear_memory(ctx: AnalysisContext) -> Iterable[Violation]:
    """Temporary memory scales no faster than its budgeted exponent.

    The Θ(u·N) pin on the delta graph path."""
    budgets = _ctx_budgets(ctx)
    yield from exponent_violations(model.scaling_report(ctx),
                                   budgets.get("exponents", {}))


@register_rule("kernel-intensity", family="cost")
def kernel_intensity(ctx: AnalysisContext) -> Iterable[Violation]:
    """Each kernel's work clears its roofline intensity floor.

    Priced from its plain version; the model's matmul FLOPs are held
    against FlopCounterMode."""
    budgets = _ctx_budgets(ctx)
    band = float(budgets.get("flop_counter_band", _DEFAULT_FLOP_BAND))
    probes = kernel_probes()
    for name, spec in sorted(budgets.get("kernels", {}).items()):
        if name not in probes:
            yield Violation("kernel-intensity", f"kernel.{name}",
                            "budgeted kernel has no probe in "
                            "cost.rules.kernel_probes")
            continue
        summary, counted = kernel_cost(*probes[name])
        yield from intensity_violations(
            name, summary, floor=float(spec.get("intensity_floor", 0.0)),
            counted_flops=counted, band=band)
