"""Static analysis of the port: the counterpart of ``repro.analysis``.

Rule families (see ``repro_torch.analysis.registry``, which also maps
each reference rule to its port):

  * ``graph``     — trace the real entry points into aten graphs and run
    them under a random-op spy: PRNG streams, masked state updates,
    dtype narrowing.
  * ``placement`` — spy on the calls that run: shard isolation on a
    client mesh, and shape bucketing of the delta update and the serve
    step.
  * ``launch``    — each hand kernel's launch geometry on odd probe
    shapes (and, on the card, launches there against the plain version).
  * ``lint``      — AST checks: bare asserts, literal CPU device
    defaults and plain-version fallbacks, unregistered registry names.
  * ``cost``      — static FLOP/byte/peak-memory budgets over aten graphs
    traced on fake tensors.

Importing this package registers every built-in rule. Run the gate with
``python -m repro_torch.launch.analyze``.
"""
from repro_torch.analysis.registry import (AnalysisContext, Rule,
                                           RuleResult, Violation, get_rule,
                                           load_baseline, register_rule,
                                           registered_rules, rules_for,
                                           run_rules, unregister_rule,
                                           write_baseline)

# imported for their registration side effects
from repro_torch.analysis import graph_rules  # noqa: E402,F401
from repro_torch.analysis import lint_rules  # noqa: E402,F401
from repro_torch.analysis import launch_rules  # noqa: E402,F401
from repro_torch.analysis import placement_rules  # noqa: E402,F401
from repro_torch.analysis.cost import rules as cost_rules  # noqa: E402,F401

__all__ = [
    "AnalysisContext", "Rule", "RuleResult", "Violation",
    "get_rule", "register_rule", "registered_rules", "rules_for",
    "run_rules", "unregister_rule", "load_baseline", "write_baseline",
]
