"""The static-analysis rule registry and runner.

A rule is a function that inspects the port (through an
``AnalysisContext``) and yields ``Violation``s. Rules register by name
under one of five families, in the policy/codec/trigger registry idiom,
so a new check drops in as

    @register_rule("my-check", family="graph")
    def my_check(ctx):
        yield Violation("my-check", "entry", "what went wrong")

and runs from ``launch/analyze.py`` with no change to the runner.

Families, and the JAX reference's family each takes the place of:

  ========= ========= ==================================================
  family    reference what it audits
  ========= ========= ==================================================
  graph     jaxpr     aten graphs of the real entry points, traced with
                      ``make_fx`` (under ``functionalize``, so in-place
                      writes come out as graph outputs): PRNG streams,
                      masked updates, dtype narrowing
  placement hlo       the calls that actually run, spied on: shard
                      isolation on a client mesh, shape bucketing
  launch    pallas    the hand kernels' launch geometry (grid, block,
                      shared memory, TMA strides) on odd probe shapes
  lint      lint      AST checks over ``src/repro_torch``
  cost      cost      FLOP/byte/peak-memory budgets over ``make_fx``
                      graphs traced on fake tensors
  ========= ========= ==================================================

Rules keep the reference's names where they keep its meaning:

  ============================== ======================================
  reference rule                 port rule
  ============================== ======================================
  prng-key-reuse                 prng-key-reuse (identical generator
                                 streams, or the global generator)
  padded-shape-key-draw          padded-shape-key-draw
  unmasked-optimizer-leaf        unmasked-optimizer-leaf
  fp32-downcast-outside-codec    fp32-downcast-outside-codec
  client-axis-collectives        client-axis-collectives (shard
                                 isolation: no shard reads another's
                                 rows)
  jit-cache-bucketing            jit-cache-bucketing (distinct row
                                 counts reaching ``pairwise_kl_pair``)
  serve-jit-bucketing            serve-jit-bucketing (distinct batch
                                 shapes reaching ``serve_step``)
  pallas-grid-divisibility       launch-geometry
  bare-assert                    bare-assert
  literal-interpret-default      literal-device-default
  unregistered-registry-name     unregistered-registry-name
  cost-budget                    cost-budget
  broadcast-blowup               broadcast-blowup
  superlinear-memory             superlinear-memory
  kernel-intensity               kernel-intensity (matmul FLOPs held
                                 against ``FlopCounterMode``)
  ============================== ======================================

A ``baseline`` (a set of ``Violation.key`` strings) suppresses known,
accepted findings; the port's own gate runs with an EMPTY baseline.
"""
from __future__ import annotations

import dataclasses
import json
import traceback
from pathlib import Path
from typing import (Callable, Dict, FrozenSet, Iterable, List, Optional,
                    Sequence, Tuple)

FAMILIES = ("graph", "placement", "launch", "lint", "cost")

# result states a rule run can end in; "error" fails the gate like a
# violation does: a crashing auditor must never read as a passing one
STATUS_OK = "ok"
STATUS_VIOLATION = "violation"
STATUS_SKIPPED = "skipped"
STATUS_ERROR = "error"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding. ``where`` is the stable location (entry-point name or
    ``path:line``) and, with the rule name, forms the baseline key;
    ``message`` carries the human detail and stays out of the key so
    shape or value churn does not invalidate a baseline entry."""
    rule: str
    where: str
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}::{self.where}"

    def as_dict(self) -> Dict[str, str]:
        return {"rule": self.rule, "where": self.where,
                "message": self.message, "key": self.key}


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    family: str
    fn: Callable[["AnalysisContext"], Iterable[Violation]]
    doc: str = ""
    # minimum CUDA devices the rule needs; short counts report "skipped"
    requires_devices: int = 0
    # the rule launches kernels, so it needs a card (and --device cuda)
    requires_cuda: bool = False


@dataclasses.dataclass
class RuleResult:
    rule: str
    family: str
    status: str
    violations: List[Violation] = dataclasses.field(default_factory=list)
    suppressed: int = 0              # baselined findings
    detail: str = ""                 # skip reason / error traceback

    @property
    def failed(self) -> bool:
        return self.status in (STATUS_VIOLATION, STATUS_ERROR)

    def as_dict(self) -> dict:
        return {"rule": self.rule, "family": self.family,
                "status": self.status, "detail": self.detail,
                "suppressed": self.suppressed,
                "n_findings": len(self.violations),
                "violations": [v.as_dict() for v in self.violations]}


_REGISTRY: Dict[str, Rule] = {}


def register_rule(name: str, family: str, requires_devices: int = 0,
                  requires_cuda: bool = False):
    """Decorator: ``@register_rule("prng-key-reuse", family="graph")``."""

    def deco(fn):
        if not isinstance(name, str) or not name:
            raise ValueError(f"rule name must be a non-empty str: {name!r}")
        if family not in FAMILIES:
            raise ValueError(f"unknown rule family {family!r}; expected "
                             f"one of {FAMILIES}")
        if name in _REGISTRY:
            raise ValueError(f"rule {name!r} already registered "
                             f"({_REGISTRY[name].fn.__qualname__})")
        if not callable(fn):
            raise TypeError(f"@register_rule expects a callable, got "
                            f"{fn!r}")
        _REGISTRY[name] = Rule(name=name, family=family, fn=fn,
                               doc=(fn.__doc__ or "").strip(),
                               requires_devices=requires_devices,
                               requires_cuda=requires_cuda)
        return fn

    return deco


def unregister_rule(name: str) -> None:
    """Remove a rule (test teardown helper)."""
    _REGISTRY.pop(name, None)


def registered_rules() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_rule(name: str) -> Rule:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown rule {name!r}; registered: "
                       f"{registered_rules()}") from None


def rules_for(families: Optional[Sequence[str]] = None,
              names: Optional[Sequence[str]] = None) -> List[Rule]:
    """Selected rules in (family, name) order: the runner's iteration."""
    if names:
        picked = [get_rule(n) for n in names]
    else:
        picked = list(_REGISTRY.values())
    if families:
        for f in families:
            if f not in FAMILIES:
                raise ValueError(f"unknown rule family {f!r}; expected "
                                 f"one of {FAMILIES}")
        picked = [r for r in picked if r.family in families]
    return sorted(picked, key=lambda r: (r.family, r.name))


class AnalysisContext:
    """What a rule sees: the package root, the device that rules which
    execute code run on, and a shared cache so expensive artifacts
    (traced graphs, parsed ASTs, probe fixtures) are built once a run,
    not once a rule.

    ``device`` is "cuda" (the default: rules that launch kernels run on
    the card) or "cpu" (they report skipped). Graph and cost traces run
    on fake tensors and touch no device either way."""

    def __init__(self, root: Optional[Path] = None, device: str = "cuda"):
        if root is None:
            # src/repro_torch/analysis/registry.py -> src/repro_torch
            root = Path(__file__).resolve().parent.parent
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got "
                             f"{device!r}")
        self.root = Path(root)
        self.device = device
        self.cache: Dict[str, object] = {}

    def python_files(self) -> List[Path]:
        key = "python_files"
        if key not in self.cache:
            self.cache[key] = sorted(self.root.rglob("*.py"))
        return self.cache[key]  # type: ignore[return-value]


def cuda_device_count() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _skip_reason(rule: Rule, ctx: AnalysisContext, n_dev: int
                 ) -> Optional[str]:
    if rule.requires_cuda and ctx.device != "cuda":
        return "launches kernels on the card; run with --device cuda"
    if rule.requires_cuda and n_dev < 1:
        return "launches kernels on the card; no CUDA device is visible"
    if n_dev < rule.requires_devices:
        return (f"needs {rule.requires_devices} CUDA devices, have "
                f"{n_dev}")
    return None


def run_rules(ctx: Optional[AnalysisContext] = None,
              families: Optional[Sequence[str]] = None,
              names: Optional[Sequence[str]] = None,
              baseline: FrozenSet[str] = frozenset()) -> List[RuleResult]:
    """Run the selected rules, filter baselined findings, never raise: a
    crashing rule becomes a ``STATUS_ERROR`` result."""
    if ctx is None:
        ctx = AnalysisContext()
    n_dev = cuda_device_count()
    results: List[RuleResult] = []
    for rule in rules_for(families, names):
        reason = _skip_reason(rule, ctx, n_dev)
        if reason is not None:
            results.append(RuleResult(rule.name, rule.family,
                                      STATUS_SKIPPED, detail=reason))
            continue
        try:
            found = list(rule.fn(ctx))
        except Exception:
            results.append(RuleResult(rule.name, rule.family, STATUS_ERROR,
                                      detail=traceback.format_exc()))
            continue
        live = [v for v in found if v.key not in baseline]
        results.append(RuleResult(
            rule.name, rule.family,
            STATUS_VIOLATION if live else STATUS_OK,
            violations=live, suppressed=len(found) - len(live)))
    return results


# --------------------------------------------------------------------------
# baseline files: a JSON list of Violation.key strings
# --------------------------------------------------------------------------

def load_baseline(path) -> FrozenSet[str]:
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"baseline file not found: {p}")
    data = json.loads(p.read_text())
    keys = data["suppressed"] if isinstance(data, dict) else data
    if not isinstance(keys, list) or \
            not all(isinstance(k, str) for k in keys):
        raise ValueError(f"baseline {p} must be a JSON list of violation "
                         f"keys (or {{'suppressed': [...]}}), got "
                         f"{type(keys).__name__}")
    return frozenset(keys)


def write_baseline(path, results: Sequence[RuleResult]) -> int:
    """Persist every live violation key; returns the count written."""
    keys = sorted({v.key for r in results for v in r.violations})
    Path(path).write_text(json.dumps({"suppressed": keys}, indent=2) + "\n")
    return len(keys)
