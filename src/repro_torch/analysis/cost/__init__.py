"""Static cost model: aten-graph FLOP/byte/peak-memory interpretation of
the audited entry points, with budgeted gates (the ``cost`` rule family).
See ``interp`` for the interpreter, ``entries`` for the parameterized
entry-point traces, ``model`` for the cost table and scaling fits, and
``rules`` for the registered gates."""
from repro_torch.analysis.cost.interp import (CostSummary, fit_exponent,
                                              summarize)
from repro_torch.analysis.cost.model import cost_table, scaling_report
from repro_torch.analysis.cost.rules import (BUDGETS_PATH, compute_budgets,
                                             load_budgets, write_budgets)

__all__ = [
    "BUDGETS_PATH", "CostSummary", "compute_budgets", "cost_table",
    "fit_exponent", "load_budgets", "scaling_report", "summarize",
    "write_budgets",
]
