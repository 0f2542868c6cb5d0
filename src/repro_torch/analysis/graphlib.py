"""Graph-walking machinery shared by the rule families.

The reference walks jaxprs; the port walks aten graphs:

  * ``trace`` — ``make_fx`` of an entry point. Autograd is traced first
    (backward ops become explicit aten nodes), then the graph is traced
    again under ``torch.func.functionalize``, so an in-place write such as
    ``cohort_step``'s ``p.copy_(...)`` becomes a value the graph returns
    rather than a mutation of an input. ``fake=True`` traces on fake
    tensors (no storage: the cost model's large shapes cost nothing).
  * ``output_dependencies`` — for each flattened output, the set of
    flattened-input positions it depends on. ``aten.copy(dst, src)``
    depends on ``src`` only (``dst`` lends its shape), so a functional
    copy-back does not read as a dependence on the old value.
  * ``find_downcasts`` — conversions that narrow fp32/fp64 to bf16/f16,
    or any float to int8/uint8.
  * ``RandomSpy`` — a ``TorchDispatchMode`` that records every random op
    that runs (ops tagged ``nondeterministic_seeded``): its output shape
    and the stream it drew from. A torch generator advances as it is
    consumed, so "the same key" means the same STREAM: generators of one
    device whose states are equal when they draw (the same
    ``initial_seed()`` at the same offset). ``generator=None`` is the
    process-global generator, which no audited entry may touch.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only

aten = torch.ops.aten

_LOW_FLOATS = (torch.bfloat16, torch.float16)
_TINY_INTS = (torch.int8, torch.uint8)
_WIDE_FLOATS = (torch.float32, torch.float64)

# dtype conversions at the aten level (the jaxpr's convert_element_type)
_CONVERSIONS = frozenset({
    aten._to_copy.default, aten.to.dtype, aten.to.dtype_layout,
    aten.to.device, aten.to.other, aten.copy.default, aten.copy_.default,
    aten._autocast_to_reduced_precision.default,
    torch.ops.prims.convert_element_type.default,
})


def trace(fn, *args, fake: bool = False, functional: bool = True
          ) -> torch.fx.GraphModule:
    """The aten graph of ``fn(*args)`` (see module docstring)."""
    mode = "fake" if fake else "real"
    gm = make_fx(fn, tracing_mode=mode)(*args)
    if not functional:
        return gm
    plain = tree_map_only(torch.Tensor, lambda a: a.detach(), args)
    func = torch.func.functionalize(gm, remove="mutations_and_views")
    return make_fx(func, tracing_mode=mode)(*plain)


def placeholders(gm: torch.fx.GraphModule) -> List[torch.fx.Node]:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def output_nodes(gm: torch.fx.GraphModule) -> List[object]:
    """The flattened outputs (nodes, or constants) of a graph."""
    out = next(n for n in gm.graph.nodes if n.op == "output")
    return tree_flatten(out.args[0])[0]


def val(node) -> Optional[torch.Tensor]:
    """The (fake) tensor a node computes, when it computes one."""
    v = node.meta.get("val") if isinstance(node, torch.fx.Node) else None
    return v if isinstance(v, torch.Tensor) else None


# --------------------------------------------------------------------------
# per-output input dependence
# --------------------------------------------------------------------------

def output_dependencies(gm: torch.fx.GraphModule) -> List[Set[int]]:
    """For each flattened output of ``gm``: the flattened-input positions
    it depends on (see module docstring)."""
    deps: Dict[torch.fx.Node, Set[int]] = {}
    for i, node in enumerate(placeholders(gm)):
        deps[node] = {i}
    for node in gm.graph.nodes:
        if node.op in ("placeholder", "output"):
            continue
        if node.op == "call_function" and node.target is aten.copy.default:
            srcs = [node.args[1]] if isinstance(node.args[1],
                                                torch.fx.Node) else []
        else:
            srcs = node.all_input_nodes
        got: Set[int] = set()
        for s in srcs:
            got |= deps.get(s, set())
        deps[node] = got
    return [deps.get(o, set()) if isinstance(o, torch.fx.Node) else set()
            for o in output_nodes(gm)]


# --------------------------------------------------------------------------
# dtype narrowing
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Downcast:
    src: str
    dst: str
    node: str


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def find_downcasts(gm: torch.fx.GraphModule) -> List[Downcast]:
    """Conversions that drop precision: fp32/fp64 to bf16/f16, or any
    float to int8/uint8 (quantization). Legal only inside the wire-codec
    boundary; the caller decides which entries get that exemption."""
    out: List[Downcast] = []
    for node in gm.graph.nodes:
        if node.op != "call_function" or node.target not in _CONVERSIONS:
            continue
        dst_val = val(node)
        srcs = [val(a) for a in node.all_input_nodes]
        # copy(dst, src): the source is the second argument
        if node.target in (aten.copy.default, aten.copy_.default):
            srcs = [val(node.args[1])] if isinstance(node.args[1],
                                                     torch.fx.Node) else []
        srcs = [s for s in srcs if s is not None]
        if dst_val is None or not srcs:
            continue
        src, dst = srcs[0].dtype, dst_val.dtype
        drop = src in _WIDE_FLOATS and dst in _LOW_FLOATS
        quant = src.is_floating_point and dst in _TINY_INTS
        if drop or quant:
            out.append(Downcast(_dtype_name(src), _dtype_name(dst),
                                node.format_node()))
    return out


# --------------------------------------------------------------------------
# random draws
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Draw:
    """One random op that ran: its aten op, output shape, and the stream
    it drew from (None for the process-global generator)."""
    op: str
    shape: Tuple[int, ...]
    stream: Optional[Tuple[str, str]]     # (device, state digest)
    seed: Optional[int]


def stream_of(gen: Optional[torch.Generator]
              ) -> Optional[Tuple[str, str]]:
    """The identity of the stream ``gen`` would draw next: its device and
    a digest of its whole state."""
    if gen is None:
        return None
    state = gen.get_state().numpy().tobytes()
    return (str(gen.device), hashlib.sha1(state).hexdigest())


class RandomSpy(TorchDispatchMode):
    """Records every random op that runs inside it (see module
    docstring). The op itself runs unchanged."""

    def __init__(self):
        super().__init__()
        self.draws: List[Draw] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        seeded = torch.Tag.nondeterministic_seeded in func.tags
        gen = kwargs.get("generator") if seeded else None
        stream = stream_of(gen) if seeded else None
        out = func(*args, **kwargs)
        if seeded:
            ref = out if isinstance(out, torch.Tensor) else args[0]
            self.draws.append(Draw(
                str(func), tuple(int(d) for d in ref.shape), stream,
                None if gen is None else gen.initial_seed()))
        return out


def spy_draws(fn, *args) -> List[Draw]:
    """Run ``fn(*args)`` and return the random ops it ran."""
    with RandomSpy() as spy:
        fn(*args)
    return spy.draws


def reused_streams(draws: Sequence[Draw]) -> List[List[Draw]]:
    """Groups of draws that overlap random streams: two or more draws
    from one stream state, and each draw from the global generator on
    its own."""
    by_stream: Dict[Tuple[str, str], List[Draw]] = {}
    bad: List[List[Draw]] = []
    for d in draws:
        if d.stream is None:
            bad.append([d])
        else:
            by_stream.setdefault(d.stream, []).append(d)
    bad.extend(g for g in by_stream.values() if len(g) >= 2)
    return bad
