"""The aten-graph cost interpreter: FLOPs, memory traffic and peak
residency.

The interpreter walks an aten graph traced by ``make_fx`` on fake tensors
(``graphlib.trace(..., fake=True, functional=False)``: views stay views
and in-place ops stay in place, as eager PyTorch runs them), turns it
into a linear program of *buffers* and *ops*, and runs three analyses:

  * **FLOPs** — a per-op model: matmuls and convolutions take
    ``torch.utils.flop_counter``'s formulas (2 x the MACs), reductions pay
    their input element count, transcendentals ``TRANSCENDENTAL_WEIGHT``
    times their output count, data movement (views, copies, gathers,
    factories, selects) nothing, and any other op one per output
    element.
  * **bytes** — a memory-traffic model: only MATERIALIZED buffers are read
    or written. A view aliases its base and moves nothing, except a
    broadcast (``expand``): as XLA's ``broadcast_in_dim`` in the
    reference's model, it is a value of its full logical size that is
    regenerated in each consumer and materializes only when it escapes
    as an output (a consumer's input size is the broadcast's). A pointwise
    producer whose single consumer is pointwise or a reduction is fused
    (it never leaves registers), as the reference's model fuses XLA's
    elementwise chains; a factory (``full``, ``arange``, ...) whose every
    consumer is fusible is regenerated in each. An in-place op aliases
    its first operand and pays for the touched region only (its other
    operands, read and written once).
  * **peak residency** — linear-scan liveness over the op list.
    ``peak_bytes`` counts every live materialized buffer (arguments
    included); ``temp_bytes`` only intermediates: buffers that are
    neither inputs nor the graph's outputs. ``temp_bytes`` is what the
    ``superlinear-memory`` rule fits: the delta graph path UPDATES the
    (N,N) cache it is handed, but must never ALLOCATE Θ(N²) afresh.

Graphs have no control flow (``make_fx`` unrolls Python loops), so there
is no trip-count multiplier.
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Dict, List, Sequence, Set

import torch
from torch.utils.flop_counter import flop_registry
from torch.utils._pytree import tree_flatten

# transcendental / special functions: several hardware ops an element
# (polynomial approximations); the multiple is a model constant, the
# reference's, not a measurement
TRANSCENDENTAL_WEIGHT = 4
_TRANSCENDENTALS = frozenset({
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sigmoid", "erf", "erfc", "erfinv", "sin", "cos", "tan", "asin",
    "acos", "atan", "atan2", "sinh", "cosh", "asinh", "acosh", "atanh",
    "pow", "rsqrt", "sqrt", "digamma", "lgamma", "softplus", "gelu",
    "silu", "logit", "xlogy", "reciprocal",
})
# softmax-like ops: an exp an element plus a max, a sum and a subtract
_SOFTMAX = frozenset({"_softmax", "_log_softmax", "logsumexp"})

# pure data movement / bookkeeping: zero flops
_MOVEMENT = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "squeeze", "unsqueeze", "slice", "select", "alias", "detach",
    "as_strided", "diagonal", "unbind", "split", "split_with_sizes",
    "clone", "copy", "copy_", "_to_copy", "to", "contiguous", "cat",
    "stack", "index", "index_select", "gather", "scatter", "index_put",
    "index_put_", "masked_fill", "masked_fill_", "where", "full", "zeros",
    "ones", "empty", "empty_like", "zeros_like", "ones_like", "full_like",
    "new_empty", "new_zeros", "new_ones", "new_full", "arange",
    "scalar_tensor", "lift_fresh_copy", "_local_scalar_dense", "fill",
    "fill_", "fill_diagonal_", "constant_pad_nd", "repeat",
    "repeat_interleave", "flip", "roll", "embedding", "nonzero",
    "empty_strided", "select_scatter", "slice_scatter", "_unsafe_index",
    "view_as_real", "view_as_complex", "unfold", "tril", "triu",
})
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "var", "std", "var_mean", "norm", "linalg_vector_norm", "cumsum",
    "cumprod", "any", "all", "topk", "count_nonzero", "bincount",
})
# factories: no input tensor, so XLA-style regeneration into consumers
_FACTORIES = frozenset({
    "full", "zeros", "ones", "arange", "scalar_tensor", "full_like",
    "zeros_like", "ones_like", "new_zeros", "new_ones", "new_full",
})
_FUSIBLE_EXTRA = frozenset({"_to_copy", "where", "masked_fill"})


def op_name(target) -> str:
    """The aten op's base name (``aten.add.Tensor`` -> ``add``)."""
    packet = getattr(target, "overloadpacket", None)
    name = getattr(packet, "__name__", None) or getattr(target, "__name__",
                                                        str(target))
    return name.split(".")[-1]


def _tags(target) -> Set:
    return set(getattr(target, "tags", ()))


# op tags, where this torch has them (older ones lack ``reduction``)
_POINTWISE = getattr(torch.Tag, "pointwise", None)
_REDUCTION = getattr(torch.Tag, "reduction", None)


def _first_alias(target):
    """(the first argument's alias info, the first return's), from the
    op's schema: what makes it a view or an in-place op."""
    schema = getattr(target, "_schema", None)
    if schema is None or not schema.arguments or not schema.returns:
        return None, None
    return schema.arguments[0].alias_info, schema.returns[0].alias_info


def is_view(target) -> bool:
    """An op whose output aliases its first operand without writing it."""
    arg, ret = _first_alias(target)
    return ret is not None and not ret.is_write and \
        (arg is None or not arg.is_write)


def is_inplace(target) -> bool:
    """An op that writes its first operand and returns it."""
    arg, ret = _first_alias(target)
    return arg is not None and arg.is_write and ret is not None


def is_pointwise(target) -> bool:
    return _POINTWISE in _tags(target) or \
        op_name(target) in _FUSIBLE_EXTRA or op_name(target) in _FACTORIES


def is_reduction(target) -> bool:
    return (_REDUCTION is not None and _REDUCTION in _tags(target)) or \
        op_name(target) in _REDUCTIONS or op_name(target) in _SOFTMAX


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _numel(x) -> int:
    return sum(t.numel() for t in _tensors(x))


def _vals(args):
    """Node arguments with every node replaced by its (fake) value."""
    return torch.fx.node.map_arg(args, lambda n: n.meta.get("val"))


def node_flops(node: torch.fx.Node) -> float:
    """The per-op FLOP model (see module docstring)."""
    target = node.target
    out = node.meta.get("val")
    packet = getattr(target, "overloadpacket", None)
    if packet in flop_registry:
        return float(flop_registry[packet](*_vals(node.args),
                                           **_vals(node.kwargs),
                                           out_val=out))
    name = op_name(target)
    out_elems = _numel(out)
    in_elems = _numel(_vals(node.args))
    if name in ("sort", "argsort"):
        return float(in_elems) * max(1.0, math.log2(max(in_elems, 2)))
    if name in _SOFTMAX:
        return float((TRANSCENDENTAL_WEIGHT + 3) * in_elems)
    if name in _MOVEMENT or is_view(target):
        return 0.0
    if is_reduction(target):
        return float(in_elems)
    if name.rstrip("_") in _TRANSCENDENTALS:
        return float(TRANSCENDENTAL_WEIGHT * out_elems)
    if torch.Tag.nondeterministic_seeded in _tags(target):
        return 16.0 * out_elems        # counter-based PRNG rounds
    return float(out_elems)


# --------------------------------------------------------------------------
# flattening
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Buffer:
    bid: int
    nbytes: int
    kind: str                  # "input" | "const" | "op"


@dataclasses.dataclass
class FlatOp:
    name: str
    target: object
    in_bufs: List[int]
    out_bufs: List[int]
    alloc: List[bool]          # per out buffer: freshly allocated here?
    flops: float
    text: str
    inplace: bool


@dataclasses.dataclass
class Program:
    buffers: Dict[int, Buffer] = dataclasses.field(default_factory=dict)
    ops: List[FlatOp] = dataclasses.field(default_factory=list)
    input_bufs: List[int] = dataclasses.field(default_factory=list)
    output_bufs: List[int] = dataclasses.field(default_factory=list)


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * int(t.element_size())


def flatten(gm: torch.fx.GraphModule) -> Program:
    """Linearize ``gm`` into buffers and ops. A node's buffer ids: one per
    tensor it computes; a view's and an in-place op's alias their first
    operand's."""
    prog = Program()
    bufs_of: Dict[torch.fx.Node, List[int]] = {}

    def new_buf(t: torch.Tensor, kind: str) -> int:
        bid = len(prog.buffers) + 1
        prog.buffers[bid] = Buffer(bid, _nbytes(t), kind)
        return bid

    for node in gm.graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            kind = "input" if node.op == "placeholder" else "const"
            ids = [new_buf(t, kind) for t in _tensors(node.meta.get("val"))]
            bufs_of[node] = ids
            if node.op == "placeholder":
                prog.input_bufs.extend(ids)
            continue
        if node.op == "output":
            for n in tree_flatten(node.args[0])[0]:
                if isinstance(n, torch.fx.Node):
                    prog.output_bufs.extend(bufs_of.get(n, []))
            continue
        in_bufs: List[int] = []
        for n in node.all_input_nodes:
            in_bufs.extend(bufs_of.get(n, []))
        if node.target is operator.getitem:
            src = bufs_of.get(node.args[0], [])
            i = node.args[1]
            bufs_of[node] = [src[i]] if isinstance(i, int) and \
                i < len(src) else []
            continue
        outs = _tensors(node.meta.get("val"))
        first = bufs_of.get(node.args[0], []) if node.args and \
            isinstance(node.args[0], torch.fx.Node) else []
        alias = bool(first) and (is_view(node.target)
                                 or is_inplace(node.target))
        if op_name(node.target) == "expand":
            # a broadcast: a value of its full logical size, regenerated
            # in every consumer (XLA's broadcast_in_dim), not an alias
            bufs_of[node] = [new_buf(outs[0], "op")]
            prog.ops.append(FlatOp("expand", node.target, in_bufs,
                                   bufs_of[node], [True], 0.0,
                                   node.format_node()[:200], False))
            continue
        if alias:
            out_bufs = [first[0]] * max(1, len(outs))
            alloc = [False] * len(out_bufs)
        else:
            out_bufs = [new_buf(t, "op") for t in outs]
            alloc = [True] * len(out_bufs)
        bufs_of[node] = out_bufs
        if is_view(node.target):
            continue                  # a view is metadata: no op runs
        prog.ops.append(FlatOp(
            op_name(node.target), node.target, in_bufs, out_bufs, alloc,
            node_flops(node), node.format_node()[:200],
            is_inplace(node.target)))
    return prog


# --------------------------------------------------------------------------
# materialization (fusion model) and the three analyses
# --------------------------------------------------------------------------

def materialized_mask(prog: Program) -> Dict[int, bool]:
    """Buffer id -> does it ever reach memory (see module docstring)?"""
    consumers: Dict[int, List[FlatOp]] = {}
    producer: Dict[int, FlatOp] = {}
    written: Set[int] = set()
    for op in prog.ops:
        for b in set(op.in_bufs):
            consumers.setdefault(b, []).append(op)
        for b, fresh in zip(op.out_bufs, op.alloc):
            if fresh:
                producer[b] = op
            else:
                written.add(b)
    outs = set(prog.output_bufs)
    mat: Dict[int, bool] = {}
    for bid, buf in prog.buffers.items():
        op = producer.get(bid)
        if buf.kind != "op" or bid in outs or bid in written or op is None:
            mat[bid] = True
            continue
        if op.name == "expand":
            mat[bid] = False          # escaping broadcasts matched above
            continue
        cons = consumers.get(bid, [])
        fusible = [c for c in cons
                   if is_pointwise(c.target) or is_reduction(c.target)]
        if op.name in _FACTORIES:
            mat[bid] = len(fusible) != len(cons)
        else:
            mat[bid] = not (is_pointwise(op.target) and len(op.out_bufs) == 1
                            and len(cons) == 1 and len(fusible) == 1)
    return mat


@dataclasses.dataclass
class CostSummary:
    """One entry point's static cost (model units, not measurements)."""
    flops: float = 0.0
    bytes: float = 0.0             # modeled memory traffic, read + write
    peak_bytes: float = 0.0        # max live incl. arguments and outputs
    temp_bytes: float = 0.0        # max live INTERMEDIATE allocations
    arg_bytes: float = 0.0
    out_bytes: float = 0.0
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    n_ops: int = 0

    @property
    def intensity(self) -> float:
        """Arithmetic intensity against argument + result traffic: the
        roofline x-axis of a perfectly fused kernel."""
        io = self.arg_bytes + self.out_bytes
        return self.flops / io if io else 0.0

    @property
    def matmul_flops(self) -> float:
        """FLOPs of the ops ``torch.utils.flop_counter`` prices."""
        return sum(v for k, v in self.flops_by_op.items()
                   if k in MATMUL_OPS)

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "peak_bytes": self.peak_bytes, "temp_bytes": self.temp_bytes,
                "arg_bytes": self.arg_bytes, "out_bytes": self.out_bytes,
                "n_ops": self.n_ops}


MATMUL_OPS = frozenset(str(k).split(".")[-1] for k in flop_registry)


def _op_traffic(op: FlatOp, prog: Program, mat: Dict[int, bool]) -> float:
    """Modeled memory bytes of ``op``."""
    if op.name == "expand":
        return 0.0                    # regenerated in its consumers
    if op.inplace:
        # the aliased operand is not streamed in full: the touched region
        # ~ the other operands, read and written once
        touched = sum(prog.buffers[b].nbytes for b in set(op.in_bufs[1:])
                      if mat[b])
        return float(2 * touched)
    read = sum(prog.buffers[b].nbytes for b in set(op.in_bufs) if mat[b])
    write = sum(prog.buffers[b].nbytes
                for b, fresh in zip(op.out_bufs, op.alloc)
                if fresh and mat[b])
    return float(read + write)


def summarize(gm: torch.fx.GraphModule) -> CostSummary:
    """The full cost interpretation of one traced entry point."""
    prog = flatten(gm)
    mat = materialized_mask(prog)
    s = CostSummary()
    s.arg_bytes = float(sum(prog.buffers[b].nbytes
                            for b in set(prog.input_bufs)))
    s.out_bytes = float(sum(prog.buffers[b].nbytes
                            for b in set(prog.output_bufs)))
    s.n_ops = len(prog.ops)
    for op in prog.ops:
        s.flops += op.flops
        if op.flops:
            s.flops_by_op[op.name] = s.flops_by_op.get(op.name, 0.0) \
                + op.flops
        s.bytes += _op_traffic(op, prog, mat)

    # linear-scan liveness
    last_use: Dict[int, int] = {}
    for i, op in enumerate(prog.ops):
        for b in op.in_bufs + op.out_bufs:
            last_use[b] = i
    end = len(prog.ops)
    pinned = set(prog.output_bufs) | set(prog.input_bufs)
    for b in pinned:
        last_use[b] = end
    outs = set(prog.output_bufs)
    live = {bid for bid, buf in prog.buffers.items()
            if buf.kind in ("input", "const")}

    def tally():
        total = sum(prog.buffers[b].nbytes for b in live if mat[b])
        temp = sum(prog.buffers[b].nbytes for b in live
                   if mat[b] and prog.buffers[b].kind == "op"
                   and b not in outs)
        return float(total), float(temp)

    peak, temp_peak = tally()
    for i, op in enumerate(prog.ops):
        for b, fresh in zip(op.out_bufs, op.alloc):
            if fresh:
                live.add(b)
        total, temp = tally()
        peak, temp_peak = max(peak, total), max(temp_peak, temp)
        live = {b for b in live if last_use.get(b, -1) > i}
    s.peak_bytes, s.temp_bytes = peak, temp_peak
    return s


# --------------------------------------------------------------------------
# blowup scan (the broadcast-blowup rule body)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Blowup:
    op: str
    ratio: float
    out_nbytes: int
    text: str


def find_blowups(gm: torch.fx.GraphModule, ratio: float, floor_bytes: int,
                 allow_ops: Sequence[str] = ()) -> List[Blowup]:
    """Materialized op outputs more than ``ratio`` x larger than all the
    op's inputs combined (a view's input is its base). Generative fills
    (every input at most 64 bytes) are exempt: that is how arrays are
    born, not a blowup; so are in-place updates and fused products that
    never reach memory."""
    prog = flatten(gm)
    mat = materialized_mask(prog)
    allow = frozenset(allow_ops)
    out: List[Blowup] = []
    for op in prog.ops:
        if op.name in allow or op.inplace:
            continue
        out_bytes = sum(prog.buffers[b].nbytes
                        for b, fresh in zip(op.out_bufs, op.alloc)
                        if fresh and mat[b])
        if out_bytes < floor_bytes:
            continue
        in_bytes = sum(prog.buffers[b].nbytes for b in set(op.in_bufs))
        if in_bytes <= 64:
            continue
        r = out_bytes / max(in_bytes, 1)
        if r > ratio:
            out.append(Blowup(op.name, r, int(out_bytes), op.text))
    return out


# --------------------------------------------------------------------------
# scaling fits
# --------------------------------------------------------------------------

def fit_exponent(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Least-squares slope of log(y) against log(x): the leading exponent
    of a power law sampled at geometrically spaced ``xs``."""
    if len(xs) != len(ys) or len(xs) < 2:
        raise ValueError(f"need >= 2 aligned samples, got {len(xs)} xs / "
                         f"{len(ys)} ys")
    lx = [math.log(float(x)) for x in xs]
    ly = [math.log(max(float(y), 1.0)) for y in ys]
    mx = sum(lx) / len(lx)
    my = sum(ly) / len(ly)
    num = sum((a - mx) * (b - my) for a, b in zip(lx, ly))
    den = sum((a - mx) ** 2 for a in lx)
    if den == 0:
        raise ValueError("scale samples must span at least two sizes")
    return num / den


def summary_of(fn, *args, fake: bool = True) -> CostSummary:
    """Trace ``fn(*args)`` (on fake tensors by default) and price it."""
    from repro_torch.analysis import graphlib
    return summarize(graphlib.trace(fn, *args, fake=fake, functional=False))
