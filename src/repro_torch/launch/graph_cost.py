"""Per-device cost of an eagerly traced step: the counterpart of the
reference's ``launch/hlo_cost.py``.

The reference partitions a jitted step with GSPMD and reads the compiled
per-device HLO text. Here the step runs eagerly with DTensor params and
inputs whose local shards are fake tensors (``launch/dryrun.py``), and
``CostCounter``, a dispatch mode, counts what one rank runs:

  * it returns ``NotImplemented`` for an op on DTensors, so DTensor's own
    dispatch runs next (the mode stays on the stack) and every op it
    issues on the LOCAL shards, and every collective it redistributes
    with, comes back to the mode: the counts are the shard's, not the
    global op's (a mode around a DTensor call that ran each op itself
    would see the global shapes, as ``FlopCounterMode`` does). The
    fake-tensor runs DTensor's sharding propagation makes to infer global
    shapes are recognised and not counted;
  * **FLOPs**: every op of ``torch.utils.flop_counter``'s registry (mm,
    bmm, addmm, baddbmm, einsum as lowered to them, convolution and their
    backward products), with its formula, 2·numel(out)·K for a product:
    on one rank, exactly ``FlopCounterMode``'s count of the same step.
    The reference counts ``dot``, ``convolution`` and ``ragged-dot``;
  * **HBM bytes**: the local input plus output bytes of every aten op that
    is neither a view nor an allocation. Eager PyTorch runs each op as
    its own kernel, so every intermediate goes through memory; XLA fuses
    elementwise chains and counts only its fusions' operands. The two
    byte counts are not comparable;
  * **collective bytes by kind**: the result bytes of each functional
    collective (``all_reduce``, ``all_gather_into_tensor``,
    ``reduce_scatter_tensor``, ``all_to_all_single`` and DTensor's
    ``shard_dim_alltoall``, their coalesced forms), weighted by the
    reference's ``_COLLECTIVE_FACTOR`` (all-reduce 2.0, the rest 1.0), with
    counts and raw bytes. DTensor redistributes without a
    collective-permute, so that kind stays 0;
  * **memory**: the bytes of every storage the step allocates, live from
    its first op to its last reference (a finalizer on the fake
    storage), as the caching allocator would hold them; the peak, and
    the event log to recompute it when some outputs are written into
    donated argument buffers instead (``peak_bytes(exclude=)``).

Python loops (the layer groups, the attention's KV chunks) run unrolled,
so there is no trip-count correction to port.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterable, List, Optional, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.cost.interp import is_view, op_name

# result-bytes multipliers, the reference's: a ring all-reduce moves ~2x
_COLLECTIVE_FACTOR = {
    "all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0,
}
COLLECTIVES = tuple(_COLLECTIVE_FACTOR)
# functional collective op -> the reference's kind
_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")
# ops that move no memory: allocations and the collectives' waits
_NO_TRAFFIC = frozenset({"empty", "empty_strided", "empty_like",
                         "new_empty", "new_empty_strided", "wait_tensor",
                         "device"})


@dataclasses.dataclass
class GraphCost:
    """Per-device totals, ``HloCost``'s fields."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0                  # weighted
    coll_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    coll_bytes_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    coll_raw_bytes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    n_ops: int = 0


def _tensors(x) -> List[torch.Tensor]:
    """The tensors among an op's arguments or results (tensors, lists and
    tuples of them, dicts of kwargs)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        return []
    out: List[torch.Tensor] = []
    for v in x:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple, dict)):
            out.extend(_tensors(v))
    return out


class _OpInfo:
    """Per-op facts the counter reads, computed once an op."""
    __slots__ = ("name", "packet", "flops", "kind", "traffic")

    def __init__(self, func):
        self.name = op_name(func)
        self.packet = getattr(func, "overloadpacket", None)
        self.flops = self.packet in flop_registry
        self.kind = _KIND.get(self.name) if getattr(
            func, "namespace", "") in _COLLECTIVE_NAMESPACES else None
        self.traffic = not is_view(func) and self.name not in _NO_TRAFFIC


_INFO: Dict[object, _OpInfo] = {}


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * int(t.element_size())


class CostCounter(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes, collectives and allocations of the
    ops run under it (see the module docstring). ``fake_mode`` is the
    ``FakeTensorMode`` the local shards live in; enter the counter inside
    it. ``mark_arguments`` registers the step's inputs, whose storages are
    not allocations of the step. ``products`` records each FLOP-counted
    op: (name, FLOPs)."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.cost = GraphCost()
        self.fake_mode = fake_mode
        self.products: List[Tuple[str, float]] = []
        self._depth = 0
        self._key: Dict[int, int] = {}          # id(storage) -> key
        self._nbytes: Dict[int, int] = {}       # key -> bytes
        self._args: Set[int] = set()            # keys of argument storages
        self.events: List[Tuple[int, int]] = []  # (key, +bytes / -bytes)

    def __enter__(self):
        if self.fake_mode is not None:
            self._depth = len(self.fake_mode.enter_stack)
        return super().__enter__()

    # -- storages ---------------------------------------------------------
    def _storage_key(self, t: torch.Tensor, is_arg: bool) -> Optional[int]:
        st = t.untyped_storage()
        sid = id(st)
        if sid in self._key:
            return self._key[sid]
        key = len(self._nbytes)
        self._key[sid] = key
        self._nbytes[key] = int(st.nbytes())
        weakref.finalize(st, self._free, sid, key)
        if is_arg:
            self._args.add(key)
        else:
            self.events.append((key, self._nbytes[key]))
        return key

    def _free(self, sid: int, key: int) -> None:
        self._key.pop(sid, None)
        if key not in self._args:
            self.events.append((key, -self._nbytes[key]))

    def mark_arguments(self, tensors: Iterable[torch.Tensor]) -> None:
        """Register the step's inputs (local shards): their storages are
        arguments, not allocations."""
        for t in tensors:
            self._storage_key(t, is_arg=True)

    def storage_keys(self, tensors: Iterable[torch.Tensor]) -> Set[int]:
        """The keys of the storages under ``tensors`` (registered ones)."""
        out = set()
        for t in tensors:
            key = self._key.get(id(t.untyped_storage()))
            if key is not None:
                out.add(key)
        return out

    def is_argument(self, key: int) -> bool:
        return key in self._args

    def storage_bytes(self, key: int) -> int:
        return self._nbytes[key]

    def peak_bytes(self, exclude: Iterable[int] = ()) -> int:
        """The peak of live allocated bytes, the storages ``exclude`` never
        allocated (outputs written into donated argument buffers)."""
        skip = set(exclude)
        live = peak = 0
        for key, n in self.events:
            if key in skip:
                continue
            live += n
            peak = max(peak, live)
        return peak

    # -- dispatch ----------------------------------------------------------
    def _shape_inference(self, args, kwargs) -> bool:
        """True inside DTensor's sharding propagation, which runs the op on
        fake tensors of the GLOBAL shapes (it re-enters the fake mode, or
        makes its own)."""
        mode = self.fake_mode
        if mode is None:
            return False
        if len(mode.enter_stack) > self._depth:
            return True
        return any(getattr(t, "fake_mode", mode) is not mode
                   for t in _tensors(args) + _tensors(kwargs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # DTensor runs it; its local ops return
        out = func(*args, **kwargs)
        if self._shape_inference(args, kwargs):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _OpInfo(func)
        c = self.cost
        c.n_ops += 1
        if info.flops:
            f = float(flop_registry[info.packet](*args, **kwargs,
                                                 out_val=out))
            c.flops += f
            self.products.append((info.name, f))
        outs = _tensors(out)
        if info.kind is not None:
            raw = sum(_nbytes(t) for t in outs)
            w = raw * _COLLECTIVE_FACTOR[info.kind]
            c.coll_counts[info.kind] += 1
            c.coll_raw_bytes[info.kind] += raw
            c.coll_bytes_by_kind[info.kind] += w
            c.coll_bytes += w
        if info.traffic:
            ins = {id(t): t for t in _tensors(args) + _tensors(kwargs)}
            c.hbm_bytes += float(sum(_nbytes(t) for t in ins.values())
                                 + sum(_nbytes(t) for t in outs))
        for t in outs:
            self._storage_key(t, is_arg=False)
