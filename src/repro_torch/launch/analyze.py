"""Static-analysis gate: run the ``repro_torch.analysis`` rules and report.

Usage (from the repo root):

    PYTHONPATH=src python -m repro_torch.launch.analyze --device cpu
    PYTHONPATH=src python -m repro_torch.launch.analyze          # the card
    PYTHONPATH=src python -m repro_torch.launch.analyze --json   # artifact
    PYTHONPATH=src python -m repro_torch.launch.analyze \\
        --baseline analysis-baseline.json                       # suppress
    PYTHONPATH=src python -m repro_torch.launch.analyze \\
        --write-baseline analysis-baseline.json                 # accept

Exits 1 if any rule reports a non-baselined violation OR crashes: a
broken auditor must fail the gate, not pass it. ``--device`` says where
the rules that execute code (the placement family's probe runs) run: on
the card (the default) or, with ``--device cpu``, on the CPU; the graph
and cost traces run on fake tensors and touch no device either way.

The reference forces an 8-device XLA host platform before importing jax
(``_force_host_devices``) so its sharded HLO audits run on a CPU. That
is an XLA detail with no counterpart here: the port's client mesh is a
tuple of devices, and the placement rules build an 8-entry one on
whatever ``--device`` names.
"""
from __future__ import annotations

import argparse
import json
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.launch.analyze",
        description="static analysis of the port (graph/placement/launch/"
                    "lint/cost)")
    p.add_argument("--json", action="store_true",
                   help="emit a JSON report instead of the human one")
    p.add_argument("--baseline", metavar="PATH",
                   help="JSON baseline of accepted violation keys")
    p.add_argument("--write-baseline", metavar="PATH",
                   help="write current violations as the new baseline "
                        "(still exits nonzero this run)")
    p.add_argument("--families", nargs="+", metavar="FAMILY",
                   help="restrict to rule families (graph placement launch "
                        "lint cost)")
    p.add_argument("--rules", nargs="+", metavar="NAME",
                   help="restrict to specific rule names")
    p.add_argument("--list-rules", action="store_true",
                   help="list registered rules and exit")
    p.add_argument("--write-budgets", nargs="?", const="", metavar="PATH",
                   help="re-baseline the measured scalars in "
                        "cost_budgets.json (policy sections preserved) "
                        "and exit; PATH overrides the checked-in file")
    p.add_argument("--cost-table", action="store_true",
                   help="print the static cost table and scaling fits and "
                        "exit")
    p.add_argument("--root", metavar="DIR",
                   help="package root to lint (default: the installed "
                        "src/repro_torch)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the rules that execute code run (default: "
                        "the card)")
    return p


_STATUS_MARK = {"ok": "PASS", "violation": "FAIL", "error": "ERROR",
                "skipped": "SKIP"}


def _human_report(results, device: str, device_count: int) -> None:
    by_family = {}
    for r in results:
        by_family.setdefault(r.family, []).append(r)
    print(f"repro_torch static analysis: {len(results)} rule(s), "
          f"--device {device}, {device_count} CUDA device(s)")
    for family in sorted(by_family):
        print(f"\n[{family}]")
        for r in by_family[family]:
            mark = _STATUS_MARK.get(r.status, r.status)
            extra = f" ({r.suppressed} baselined)" if r.suppressed else ""
            print(f"  {mark:5s} {r.rule}{extra}")
            if r.status == "skipped":
                print(f"        {r.detail}")
            elif r.status == "error":
                last = r.detail.strip().splitlines()[-1] if r.detail else ""
                print(f"        rule crashed: {last}")
                for line in r.detail.rstrip().splitlines():
                    print(f"        | {line}")
            for v in r.violations:
                print(f"        {v.where}")
                print(f"          {v.message}")
    failed = [r for r in results if r.failed]
    print()
    if failed:
        print(f"FAILED: {len(failed)} rule(s) with findings: fix them or "
              f"baseline with --write-baseline")
    else:
        print("clean: no findings")


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    import repro_torch.analysis  # noqa: F401  (registers the rules)
    from repro_torch.analysis.registry import (FAMILIES, AnalysisContext,
                                               cuda_device_count, get_rule,
                                               load_baseline,
                                               registered_rules, rules_for,
                                               run_rules, write_baseline)

    if args.list_rules:
        by_family: dict = {}
        for name in registered_rules():
            by_family.setdefault(get_rule(name).family, []).append(name)
        total = sum(len(v) for v in by_family.values())
        print(f"{total} rule(s) in {len(by_family)} family(ies)")
        for family in sorted(by_family):
            names = by_family[family]
            print(f"\n[{family}] {len(names)} rule(s)")
            for name in names:
                rule = get_rule(name)
                doc = rule.doc.splitlines()[0] if rule.doc else ""
                print(f"  {name}: {doc}")
        return 0

    ctx = AnalysisContext(root=args.root, device=args.device)

    if args.write_budgets is not None:
        from repro_torch.analysis.cost import rules as cost_rules
        path = args.write_budgets or cost_rules.BUDGETS_PATH
        cost_rules.write_budgets(path, ctx)
        print(f"wrote cost budgets to {path}", file=sys.stderr)
        return 0

    if args.cost_table:
        from repro_torch.analysis.cost import model as cost_model
        print(cost_model.format_table(cost_model.cost_table(ctx),
                                      cost_model.scaling_report(ctx)))
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else frozenset()
    # resolve the selection BEFORE running: a typo'd family or rule name
    # that matches nothing must be a loud non-zero exit, not a green gate
    # over zero rules
    try:
        selected = rules_for(families=args.families, names=args.rules)
    except (KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not selected:
        print(f"error: selection matched zero rules "
              f"(families={args.families}, rules={args.rules}); known "
              f"families: {', '.join(FAMILIES)}; see --list-rules",
              file=sys.stderr)
        return 2
    results = run_rules(ctx, families=args.families, names=args.rules,
                        baseline=baseline)

    if args.write_baseline:
        n = write_baseline(args.write_baseline, results)
        print(f"wrote {n} violation key(s) to {args.write_baseline}",
              file=sys.stderr)

    failed = any(r.failed for r in results)
    n_dev = cuda_device_count()
    if args.json:
        print(json.dumps({"rules": [r.as_dict() for r in results],
                          "failed": failed, "device": args.device,
                          "device_count": n_dev}, indent=2))
    else:
        _human_report(results, args.device, n_dev)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
