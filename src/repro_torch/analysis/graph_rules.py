"""Graph auditors: PRNG streams, masked updates, dtype narrowing.

Each rule audits the real entry points (``fixtures.build_entries``) and
delegates to an ``audit_*`` helper that takes a graph, a list of draws or
a function directly: the tests drive those helpers with seeded-bug
variants to prove the detectors fire.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from torch.utils._pytree import tree_flatten_with_path, keystr

from repro_torch.analysis import fixtures, graphlib
from repro_torch.analysis.registry import (AnalysisContext, Violation,
                                           register_rule)


# --------------------------------------------------------------------------
# audit helpers (rule bodies, callable on arbitrary graphs and draws)
# --------------------------------------------------------------------------

def audit_key_reuse(where: str,
                    draws: Sequence[graphlib.Draw]) -> List[Violation]:
    """Two random ops drawing from one stream state (equal-seeded
    generators at one offset: overlapping random streams), or a draw from
    the process-global generator."""
    out = []
    for i, group in enumerate(graphlib.reused_streams(draws)):
        ops = ", ".join(d.op for d in group)
        if group[0].stream is None:
            msg = (f"{ops} draws from the process-global generator; pass "
                   f"an explicit torch.Generator")
        else:
            msg = (f"{len(group)} draws ({ops}) from one stream state "
                   f"(seed {group[0].seed}): overlapping random streams; "
                   f"give each use its own generator or let one advance")
        out.append(Violation("prng-key-reuse", f"{where}#stream{i}", msg))
    return out


def audit_padded_draws(where: str, draws: Sequence[graphlib.Draw],
                       padded: Tuple[int, int]) -> List[Violation]:
    """Random draws at the ghost-padded row count: a draw's values depend
    on its shape, so a draw at ``padded_dim`` instead of ``real_dim``
    changes every REAL client's stream whenever the mesh (and hence the
    pad) changes."""
    padded_dim, real_dim = padded
    if padded_dim == real_dim:
        return []
    out = []
    for i, d in enumerate(draws):
        if padded_dim in d.shape:
            out.append(Violation(
                "padded-shape-key-draw", f"{where}#draw{i}",
                f"random draw {d.op} at shape {d.shape} includes the "
                f"padded row count {padded_dim}; draw at the real count "
                f"{real_dim} and edge-replicate the pad (see "
                f"data/pipeline.cohort_batch_padded)"))
    return out


def audit_masked_update(wrapper, args, leaf_counts: Sequence[int],
                        gate_arg: int, checked_args: Sequence[int],
                        where: str,
                        arg_names: Optional[Sequence[str]] = None
                        ) -> List[Violation]:
    """Every output tensor that updates a ``checked_args`` input (state a
    frozen client must not advance) must DEPEND on the ``gate_arg`` input
    (the trainable mask): one with no such dependence escapes the freeze.

    The wrapper returns the updated versions of its checked arguments
    first, tensor for tensor in their order; ``leaf_counts`` gives each
    argument's tensor count (its placeholders in the traced graph)."""
    gm = graphlib.trace(wrapper, *args)
    deps = graphlib.output_dependencies(gm)
    n_in = len(graphlib.placeholders(gm))

    starts = []
    pos = 0
    for n in leaf_counts:
        starts.append(pos)
        pos += n
    if pos != n_in:
        raise ValueError(f"leaf_counts sum {pos} != placeholder count "
                         f"{n_in}: fixture out of sync")
    gate = set(range(starts[gate_arg], starts[gate_arg]
                     + leaf_counts[gate_arg]))
    names = list(arg_names) if arg_names else \
        [f"arg{i}" for i in range(len(leaf_counts))]
    out_paths = [keystr(kp) for kp, _ in
                 tree_flatten_with_path(wrapper(*args))[0]]

    out = []
    cursor = 0
    for a in checked_args:
        for leaf in range(leaf_counts[a]):
            oi = cursor + leaf
            if not deps[oi] & gate:
                path = out_paths[oi] if oi < len(out_paths) else f"[{oi}]"
                out.append(Violation(
                    "unmasked-optimizer-leaf", f"{where}#{names[a]}{path}",
                    f"updated {names[a]} tensor {path} does not depend on "
                    f"the trainable mask: a frozen client's state would "
                    f"silently advance; gate EVERY tensor "
                    f"(torch.where(on, new, old))"))
        cursor += leaf_counts[a]
    return out


def audit_downcasts(where: str, gm) -> List[Violation]:
    """Silent fp32 -> bf16/f16 (or float -> int8/uint8 quantization)
    outside the wire-codec boundary."""
    out = []
    seen = set()
    for d in graphlib.find_downcasts(gm):
        sig = (d.src, d.dst)
        if sig in seen:
            continue
        seen.add(sig)
        out.append(Violation(
            "fp32-downcast-outside-codec", f"{where}#{d.src}->{d.dst}",
            f"{d.src} -> {d.dst} conversion in a non-codec entry point; "
            f"precision drops belong in wire codecs (core/wire.py), not "
            f"the compute path"))
    return out


# --------------------------------------------------------------------------
# registered rules
# --------------------------------------------------------------------------

@register_rule("prng-key-reuse", family="graph")
def prng_key_reuse(ctx: AnalysisContext) -> Iterable[Violation]:
    """No two draws from one generator stream, none from the global one.

    Runs every entry point under a random-op spy."""
    for name, entry in sorted(fixtures.build_entries(ctx).items()):
        yield from audit_key_reuse(name, entry.draws)


@register_rule("padded-shape-key-draw", family="graph")
def padded_shape_key_draw(ctx: AnalysisContext) -> Iterable[Violation]:
    """No random draw at a ghost-padded row count."""
    for name, entry in sorted(fixtures.build_entries(ctx).items()):
        if entry.padded is not None:
            yield from audit_padded_draws(name, entry.draws, entry.padded)


@register_rule("unmasked-optimizer-leaf", family="graph")
def unmasked_optimizer_leaf(ctx: AnalysisContext) -> Iterable[Violation]:
    """Every updated tensor of the cohort step depends on the mask.

    Params and optimizer state, the per-client step counter included."""
    wrapper, make_args, leaf_counts, arg_names = fixtures.cohort_step_probe()
    # wrapper(params, opt_state, bx, by, ref_x, targets, trainable) returns
    # (params, opt_state, loss): check args 0 and 1, the gate is arg 6
    yield from audit_masked_update(
        wrapper, make_args(), leaf_counts, gate_arg=6, checked_args=(0, 1),
        where="cohort_step", arg_names=arg_names)


@register_rule("fp32-downcast-outside-codec", family="graph")
def fp32_downcast_outside_codec(ctx: AnalysisContext) -> Iterable[Violation]:
    """No precision-dropping conversion outside the wire codecs.

    The codec boundary is the one sanctioned quantization site."""
    for name, entry in sorted(fixtures.build_entries(ctx).items()):
        if not entry.codec_boundary:
            yield from audit_downcasts(name, entry.graph)
