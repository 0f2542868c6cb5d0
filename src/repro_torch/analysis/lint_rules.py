"""AST lint rules over the ``src/repro_torch`` tree.

Pure-Python checks that need no tracing: bare ``assert`` in library code
(stripped under ``python -O``), literal CPU defaults that would pin the
port's dispatch-by-device rule (an entry point runs on the card unless
its caller asks for the CPU, and a kernel wrapper takes its plain
version only because its tensors lie on the CPU), and string registry
lookups that name nothing registered (a typo'd ``get_policy("sqdm")``
should die in the gate, not at round 40).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.registry import (AnalysisContext, Violation,
                                           register_rule)


def _parse(path: Path) -> Optional[ast.AST]:
    try:
        return ast.parse(path.read_text(), filename=str(path))
    except SyntaxError:
        return None     # surfaced by import anyway; not a lint concern


def _rel(ctx: AnalysisContext, path: Path) -> str:
    try:
        return str(path.relative_to(ctx.root))
    except ValueError:
        return str(path)


def _iter_trees(ctx: AnalysisContext) -> Iterator[Tuple[Path, ast.AST]]:
    cached = ctx.cache.get("ast_trees")
    if cached is None:
        cached = []
        for path in ctx.python_files():
            tree = _parse(path)
            if tree is not None:
                cached.append((path, tree))
        ctx.cache["ast_trees"] = cached
    return iter(cached)


# --------------------------------------------------------------------------
# bare assert
# --------------------------------------------------------------------------

def find_bare_asserts(tree: ast.AST, relpath: str) -> List[Violation]:
    """``assert`` in library code vanishes under ``python -O``; guards
    must raise typed exceptions. Functions named ``_kernel*`` or
    ``*_kernel`` are exempt, as the reference exempts its kernel bodies."""
    out = []
    exempt_spans: List[Tuple[int, int]] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                (node.name.startswith("_kernel")
                 or node.name.endswith("_kernel")):
            exempt_spans.append((node.lineno, node.end_lineno or node.lineno))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assert):
            continue
        if any(lo <= node.lineno <= hi for lo, hi in exempt_spans):
            continue
        out.append(Violation(
            "bare-assert", f"{relpath}:{node.lineno}",
            "bare assert in library code is stripped under python -O; "
            "raise ValueError/RuntimeError instead"))
    return out


@register_rule("bare-assert", family="lint")
def bare_assert(ctx: AnalysisContext) -> Iterable[Violation]:
    """No ``assert`` in ``src/repro_torch`` outside kernel bodies."""
    for path, tree in _iter_trees(ctx):
        yield from find_bare_asserts(tree, _rel(ctx, path))


# --------------------------------------------------------------------------
# literal device defaults
# --------------------------------------------------------------------------

def _is_cpu_literal(node: Optional[ast.AST]) -> bool:
    """``"cpu"`` or ``torch.device("cpu")`` (any spelling of the call)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and \
            node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and node.args and not node.keywords:
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else \
            fn.id if isinstance(fn, ast.Name) else None
        return name == "device" and _is_cpu_literal(node.args[0])
    return False


def _call_name(node: ast.Call) -> Optional[str]:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _is_plain_call(node: ast.AST) -> bool:
    """A call of a kernel's plain version: ``plain(...)``, a ``*_ref``
    function, or anything reached through the ``ref`` module."""
    if not isinstance(node, ast.Call):
        return False
    name = _call_name(node)
    if name == "plain" or (name or "").endswith("_ref"):
        return True
    fn = node.func
    return isinstance(fn, ast.Attribute) and \
        isinstance(fn.value, ast.Name) and fn.value.id == "ref"


def find_literal_device(tree: ast.AST, relpath: str) -> List[Violation]:
    """Two ways to hide the card: a public function whose ``device``
    parameter defaults to a literal CPU device (entry points run on the
    card unless the caller asks, ``device=None`` resolving to it), and,
    in ``kernels/``, an ``except`` around a kernel launch whose handler
    falls back to the plain version (a wrapper on a CUDA tensor launches
    its kernel or raises)."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or node.name.startswith("_"):
            continue
        a = node.args
        params = a.posonlyargs + a.args + a.kwonlyargs
        defaults = ([None] * (len(a.posonlyargs + a.args) - len(a.defaults))
                    + list(a.defaults) + list(a.kw_defaults))
        for param, default in zip(params, defaults):
            if param.arg == "device" and _is_cpu_literal(default):
                out.append(Violation(
                    "literal-device-default", f"{relpath}:{node.lineno}",
                    f"def {node.name}(... device={ast.unparse(default)} "
                    f"...): a literal CPU default pins the entry point off "
                    f"the card; default to None (the card) and let the "
                    f"caller ask for the CPU"))
    if "kernels" in Path(relpath).parts[:-1]:
        for node in ast.walk(tree):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                if any(_is_plain_call(n) for h in handler.body
                       for n in ast.walk(h)):
                    out.append(Violation(
                        "literal-device-default",
                        f"{relpath}:{handler.lineno}",
                        "an except around a kernel launch falls back to the "
                        "plain version: on a CUDA tensor a wrapper launches "
                        "its kernel or raises"))
    return out


@register_rule("literal-device-default", family="lint")
def literal_device_default(ctx: AnalysisContext) -> Iterable[Violation]:
    """No literal CPU device default, no plain-version fallback.

    A public function's ``device`` defaults to None (the card); no
    kernel wrapper catches a launch failure and runs the plain version."""
    for path, tree in _iter_trees(ctx):
        yield from find_literal_device(tree, _rel(ctx, path))


# --------------------------------------------------------------------------
# unregistered registry names
# --------------------------------------------------------------------------

def live_registries() -> Dict[str, Set[str]]:
    """Lookup-function name -> the set of names its registry knows.
    Imports ``repro_torch.core`` and ``repro_torch.serve`` so decorator
    registration has run (the serve package adds query arrivals and batch
    policies)."""
    import repro_torch.core  # noqa: F401  (policy/codec registries)
    import repro_torch.serve  # noqa: F401  (query arrivals, batch policies)
    from repro_torch.analysis.registry import registered_rules
    from repro_torch.core.policies.base import registered_policies
    from repro_torch.core.runtime import registered_triggers
    from repro_torch.core.schedules import (registered_arrivals,
                                            registered_schedules)
    from repro_torch.core.wire import registered_codecs
    from repro_torch.models.zoo import registered_families
    from repro_torch.serve.queue import registered_batch_policies

    policies = set(registered_policies())
    codecs = set(registered_codecs())
    triggers = set(registered_triggers())
    schedules = set(registered_schedules())
    arrivals = set(registered_arrivals())
    rules = set(registered_rules())
    batch_policies = set(registered_batch_policies())
    families = set(registered_families())
    return {
        "get_policy": policies, "as_policy": policies,
        "get_codec": codecs, "as_codec": codecs,
        "get_trigger": triggers, "as_trigger": triggers,
        "get_schedule": schedules, "as_schedule": schedules,
        "get_arrivals": arrivals, "as_arrivals": arrivals,
        "get_batch_policy": batch_policies,
        "as_batch_policy": batch_policies,
        "get_rule": rules,
        "get_family": families, "as_family": families,
    }


def find_unregistered_names(tree: ast.AST, relpath: str,
                            registries: Dict[str, Set[str]]
                            ) -> List[Violation]:
    """Registry lookups with a literal-string first argument naming
    nothing registered. ``as_*`` specs may carry a ``name:int`` suffix
    (``"topk:2"`` wire codec, ``"micro:16"`` batch policy): the prefix
    must name a registered entry AND the suffix must be a positive int,
    which is what every parameterized registry parses it as."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn_name = _call_name(node)
        if fn_name not in registries or not node.args:
            continue
        arg = node.args[0]
        if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
            continue
        name = arg.value
        if fn_name.startswith("as_"):
            name, sep, suffix = name.partition(":")
            if sep:
                try:
                    ok = int(suffix) > 0
                except ValueError:
                    ok = False
                if not ok:
                    out.append(Violation(
                        "unregistered-registry-name",
                        f"{relpath}:{node.lineno}",
                        f"{fn_name}({arg.value!r}) has a malformed spec "
                        f"suffix {suffix!r}; parameterized specs take a "
                        f"positive int (e.g. 'topk:2', 'micro:16')"))
        if name not in registries[fn_name]:
            out.append(Violation(
                "unregistered-registry-name", f"{relpath}:{node.lineno}",
                f"{fn_name}({arg.value!r}) names nothing registered; "
                f"known: {', '.join(sorted(registries[fn_name]))}"))
    return out


@register_rule("unregistered-registry-name", family="lint")
def unregistered_registry_name(ctx: AnalysisContext) -> Iterable[Violation]:
    """Every literal-string registry lookup names a registered entry."""
    registries = live_registries()
    for path, tree in _iter_trees(ctx):
        yield from find_unregistered_names(tree, _rel(ctx, path),
                                           registries)
