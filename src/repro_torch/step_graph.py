"""A cohort shard's step as one CUDA graph, replayed from one launch.

On the card a cohort's step issues thousands of small kernels (vmap's
per-op launches, the autograd backward, the per-leaf gated update), so
the host's launch rate, not the card, sets its pace. ``StepGraphs``, one
a ``CohortShard``, captures the shard's step (the batch gather, forward,
``torch.autograd.grad``, the optimizer update, the gated ``copy_`` of the
params and the state gate) into a ``torch.cuda.CUDAGraph`` and replays
it.

A step's key is what its kernels bake in: the storage, shape, stride and
dtype of every tensor the step reads or writes where it lies (``fixed``:
the params, module buffers and the shard's data), the shapes and dtypes
of the per-call inputs and of the optimizer state, the caller's static
values (``rho``, ``use_ref``, the optimizer), the card, and the float32
matmul and cuDNN modes. For each key:

1. the first call runs eagerly, as the warm-up the ``torch.cuda.graphs``
   docs ask for, with the card warning at each blocking sync; a key
   whose warm-up synced stays eager for good. The warm-up runs on the
   caller's stream and not on a side stream: each stream has a cuBLAS
   workspace of its own (64 MiB on the H100), kept for the process;
2. the second call captures the step on the card's capture stream into
   the card's private memory pool and replays it; a capture that fails
   (out of memory included) has executed nothing, so the key stays
   eager for good (with a warning) and the step runs eagerly;
3. every later call copies its inputs into the graph's buffers and
   replays.

The graph reads the per-call inputs from buffers it owns, and reads and
writes the optimizer state where it lies: the state's tensors at capture
become its buffers, and the captured step ends by ``copy_``-ing the new
state into them. A state made of other tensors (a checkpoint restore, an
assignment) is copied into the buffers before a replay. So a replayed
step returns the same state tensors each time, updated in place: a
caller that keeps a state across a step and needs its old values clones
it. Params are updated in place as the eager step updates them.

In a ``trace.recording`` each step counts under ``graph.eager`` (run
eagerly on the card, warm-ups included), ``graph.captures`` or
``graph.replays``, inside a ``client.capture`` or ``client.replay`` span;
the hand kernels' launch counters (``kernels.ops``) count a replay's
launches as if they had been issued. Nothing here runs off the card.
"""
from __future__ import annotations

import dataclasses
import warnings
import weakref
from typing import Callable, Dict, Hashable, List, Optional, Sequence

import torch

from repro_torch import trace
from repro_torch.optim import state_tensors

# what the card's sync-debug mode says at a blocking sync, and the notice
# it gives once when first turned on
SYNC_WARNING = "called a synchronizing CUDA operation"
MODE_NOTICE = "Synchronization debug mode"

# (inputs on the card, state) -> the new state
Step = Callable[[Sequence[torch.Tensor], object], object]

# Per card: the stream every capture runs on, and the live graphs, all
# captured into one private memory pool. A graph keeps nothing alive in
# the pool (its outputs are copied into tensors outside it) and graphs
# replay one after another on the caller's stream, so the pool holds the
# largest step's temporaries, not their sum. Once no graph of the pool
# lives, the next capture takes a new one.
_STREAMS: Dict[int, torch.cuda.Stream] = {}
_LIVE: Dict[int, "weakref.WeakSet[_Graph]"] = {}

_WARM = "warm"      # warmed up without a sync: capture on the next call
_EAGER = "eager"    # synced in its warm-up, or its capture failed


def _pool(device: torch.device) -> tuple:
    for g in _LIVE.setdefault(device.index, weakref.WeakSet()):
        return g.graph.pool()
    return torch.cuda.graph_pool_handle()


def _modes() -> tuple:
    """The global settings that choose the step's kernels."""
    cudnn = torch.backends.cudnn
    return (torch.get_float32_matmul_precision(), cudnn.enabled,
            cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled())


def _where(fixed: Sequence[torch.Tensor]) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in fixed)


def _shapes(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


@dataclasses.dataclass(eq=False)
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]     # its own input buffers
    state: object                  # the optimizer state over its buffers
    leaves: List[torch.Tensor]     # ``state``'s tensors
    launches: Dict[str, int]       # hand-kernel launches a replay


def _warm_up(step: Step, inputs, state, device: torch.device):
    """(new state, whether the step synced): ``step`` run eagerly with
    the card warning at each blocking sync. Other warnings, and the sync
    warnings of a caller that had the mode on already, are given again
    once the step is done."""
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if mode == 0:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            new = step([t.to(device) for t in inputs], state)
        finally:
            if mode == 0:
                torch.cuda.set_sync_debug_mode(0)
    synced = False
    for w in caught:
        text = str(w.message)
        synced |= SYNC_WARNING in text
        if mode == 0 and (SYNC_WARNING in text
                          or text.startswith(MODE_NOTICE)):
            continue
        warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    return new, synced


def _capture(step: Step, inputs, state,
             device: torch.device) -> Optional[_Graph]:
    """``step`` captured from its own input buffers and ``state``'s
    tensors, ending in the new state's ``copy_`` into them; None if the
    capture failed. Nothing is executed."""
    from repro_torch.kernels import ops
    bufs = [torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)
            for t in inputs]
    leaves = state_tensors(state)
    # as ``torch.cuda.graph`` does: the cache's unused blocks go back to
    # the card, so the private pool can take what the capture allocates
    torch.cuda.empty_cache()
    if device.index not in _STREAMS:
        _STREAMS[device.index] = torch.cuda.Stream(device)
    side = _STREAMS[device.index]
    side.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    before = ops.all_counts()
    failed = None
    # as PyTorch's own CUDA-graph trees do around a capture, every
    # stream's cached cuBLAS workspace is dropped: the one the capture
    # needs is taken from the private pool and given back to it after,
    # and no stream holds a second one at the step's peak
    torch._C._cuda_clearCublasWorkspaces()
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(pool=_pool(device))
            try:
                new = state_tensors(step(bufs, state))
                torch._foreach_copy_(leaves, new)
                del new
            finally:
                graph.capture_end()
    except RuntimeError as err:     # torch.OutOfMemoryError included
        failed = err
    finally:
        torch._C._cuda_clearCublasWorkspaces()
    # the wrappers counted launches that were only captured
    launches = {k: n - before[k] for k, n in ops.all_counts().items()
                if n != before[k]}
    ops.add_launch_counts({k: -n for k, n in launches.items()})
    if failed is not None:
        warnings.warn(f"the step could not be captured as a CUDA graph "
                      f"and runs eagerly from now on: {failed}",
                      RuntimeWarning)
        return None
    g = _Graph(graph, bufs, state, leaves, launches)
    _LIVE[device.index].add(g)
    return g


def _replay(g: _Graph, inputs, state):
    from repro_torch.kernels import ops
    for b, t in zip(g.inputs, inputs):
        b.copy_(t)
    for b, t in zip(g.leaves, state_tensors(state)):
        if t is not b:
            b.copy_(t)
    g.graph.replay()
    if g.launches:
        ops.add_launch_counts(g.launches)
    trace.count("graph.replays")
    return g.state


class StepGraphs:
    """One cohort shard's steps by key: warmed up, captured and
    replayed. A deep copy starts empty."""

    def __init__(self):
        self._keys: Dict[tuple, object] = {}   # _WARM, _EAGER or _Graph

    def __deepcopy__(self, memo) -> "StepGraphs":
        # a deep copy's tensors lie elsewhere: no graph of this one fits
        return StepGraphs()

    def captured(self) -> int:
        """Captured graphs held."""
        return sum(isinstance(v, _Graph) for v in self._keys.values())

    def step(self, step: Step, inputs: Sequence[torch.Tensor], state, *,
             fixed: Sequence[torch.Tensor], static: Hashable,
             device: torch.device, cohort: Optional[str] = None):
        """``step(inputs on the card, state)`` on ``device``, eagerly, by
        capture or by replay; returns the new state."""
        where = _where(fixed)
        key = (where, device.index, _shapes(inputs), type(state),
               _shapes(state_tensors(state)), static, _modes())
        got = self._keys.get(key)
        with torch.cuda.device(device):
            if got is None:
                trace.count("graph.eager")
                new, synced = _warm_up(step, inputs, state, device)
                self._keys[key] = _EAGER if synced else _WARM
                return new
            if got is _WARM:
                with trace.span("client.capture", cohort=cohort):
                    got = _capture(step, inputs, state, device)
                if got is None:
                    self._keys[key] = got = _EAGER
                else:
                    trace.count("graph.captures")
                    # graphs over storage that has moved can never
                    # replay again: let their memory go
                    self._keys = {k: v for k, v in self._keys.items()
                                  if k[0] == where}
                    self._keys[key] = got
            if got is _EAGER:
                trace.count("graph.eager")
                return step([t.to(device) for t in inputs], state)
            with trace.span("client.replay", cohort=cohort):
                return _replay(got, inputs, state)
