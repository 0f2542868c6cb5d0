"""What a ``--trace 1`` run records for the per-layer metrics, from the
benchmark's own files: nothing is traced inside the port.

* Spans: the engine's layer calls a metric names (``SPANS``, paths from
  the engine such as ``"clients.local_round"``) are wrapped on the
  instance, the card synchronized on both sides, over a few rounds.
* Profile: a few rounds under ``torch.profiler`` with the same calls
  marked as ranges (no synchronization): device busy time, kernels,
  device time by operation, and the idle gaps labelled by what the host
  was doing.
* Ranges: a module attribute a metric names (``RANGES``, e.g. the port's
  ``repro_torch.core.similarity.divergence_matrix``) is wrapped in a
  profiler range with the card synchronized inside it, so every device
  operation in the range's interval is the call's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

TOP = 10                # entries of each breakdown list
LABELLED_GAPS = 256     # the longest idle gaps given a label


@dataclasses.dataclass
class Context:
    """What the metric readers read."""
    config: dict
    n_clients: int
    ref_size: int
    n_classes: int
    length: int
    peaks: dict
    awake_share: float = 1.0          # awake clients over the window
    window: dict = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    span_rounds: int = 0
    profile: dict = dataclasses.field(default_factory=dict)
    ranges: Dict[str, dict] = dataclasses.field(default_factory=dict)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _resolve(engine, path: str) -> Tuple[object, str]:
    *parts, attr = path.split(".")
    obj = engine
    for p in parts:
        obj = getattr(obj, p)
    return obj, attr


@contextlib.contextmanager
def wrapped(engine, paths: Iterable[str], make: Callable):
    """Each engine call of ``paths`` replaced, on its instance, by
    ``make(path, original)``; restored after."""
    done = []
    try:
        for path in paths:
            obj, attr = _resolve(engine, path)
            setattr(obj, attr, make(path, getattr(obj, attr)))
            done.append((obj, attr))
        yield
    finally:
        for obj, attr in done:
            delattr(obj, attr)


@contextlib.contextmanager
def patched(targets: Dict[str, Tuple[str, str]], make: Callable):
    """Module attributes (label -> (module, attr)) replaced by
    ``make(label, original)``; restored after."""
    done = []
    try:
        for label, (mod_name, attr) in targets.items():
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            setattr(mod, attr, make(label, orig))
            done.append((mod, attr, orig))
        yield
    finally:
        for mod, attr, orig in done:
            setattr(mod, attr, orig)


def spans(engine, paths: List[str], rounds: Iterable[int], device
          ) -> Dict[str, List[float]]:
    """Seconds of each call of ``paths`` over ``rounds``."""
    got: Dict[str, List[float]] = defaultdict(list)

    def make(path, fn):
        def timed(*a, **kw):
            sync(device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync(device)
            got[path].append(time.perf_counter() - t0)
            return out
        return timed

    with wrapped(engine, paths, make):
        for rnd in rounds:
            engine.run_round(rnd)
            sync(device)
    return {p: got.get(p, []) for p in paths}


def _marked(label: str, fn):
    def call(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    return call


def _device_events(events) -> list:
    """Operations that ran on the card: kernels, copies, memsets, not
    the annotations the profiler mirrors onto the card's timeline."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("portbench")]


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged (start, end) rows of ``intervals`` sorted by start."""
    if len(intervals) == 0:
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out)


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "[memory]"))


def profile(engine, paths: List[str], rounds: List[int], device) -> dict:
    """Device busy time, kernels, time by operation and labelled idle
    gaps over ``rounds`` under the profiler. Empty where the profiler
    recorded no device operation."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    label = "portbench:window"
    with wrapped(engine, paths, lambda p, fn: _marked(f"portbench:{p}",
                                                      fn)):
        sync(device)
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(label):
                for rnd in rounds:
                    engine.run_round(rnd)
                    sync(device)
    events = prof.events()
    win = [e for e in events if e.name == label]
    dev = _device_events(events)
    if not win or not dev:
        return {}
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    iv = np.array([[e.time_range.start, e.time_range.end] for e in dev],
                  float)
    iv = np.clip(iv, w0, w1)
    merged = _union(iv[iv[:, 1] > iv[:, 0]])
    busy_us = float((merged[:, 1] - merged[:, 0]).sum()) if len(merged) \
        else 0.0
    by_op: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_op[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    edges = np.concatenate([[w0], merged.ravel(), [w1]]) if len(merged) \
        else np.array([w0, w1])
    gaps = edges.reshape(-1, 2)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    return {"rounds": len(rounds), "window_s": (w1 - w0) * 1e-6,
            "busy_s": busy_us * 1e-6,
            "kernels": sum(_is_kernel(e.name) for e in dev),
            "device_ops": sorted(([k, v] for k, v in by_op.items()),
                                 key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": _label_gaps(gaps, events)}


def _label_gaps(gaps: np.ndarray, events) -> list:
    """Idle seconds by what the host was doing: the innermost harness
    range and the innermost host operation around each of the longest
    gaps; the rest of the idle time under ``"other gaps"``."""
    from torch.autograd import DeviceType
    if len(gaps) == 0:
        return []
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    starts = np.array([e.time_range.start for e in cpu], float)
    ends = np.array([e.time_range.end for e in cpu], float)
    names = [e.name for e in cpu]
    length = gaps[:, 1] - gaps[:, 0]
    order = np.argsort(-length)
    total: Dict[str, float] = defaultdict(float)
    for i in order[:LABELLED_GAPS]:
        mid = 0.5 * (gaps[i, 0] + gaps[i, 1])
        cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
        layer, op = "-", "-"
        inner_layer = inner_op = None
        for j in cover:
            span = ends[j] - starts[j]
            if names[j].startswith("portbench:"):
                if names[j] != "portbench:window" and (
                        inner_layer is None or span < inner_layer[0]):
                    inner_layer = (span, names[j][len("portbench:"):])
            elif inner_op is None or span < inner_op[0]:
                inner_op = (span, names[j])
        if inner_layer:
            layer = inner_layer[1]
        if inner_op:
            op = inner_op[1]
        total[f"{layer}/{op}"] += length[i] * 1e-6
    rest = float(length[order[LABELLED_GAPS:]].sum()) * 1e-6
    if rest > 0:
        total["other gaps"] += rest
    return sorted(([k, v] for k, v in total.items()),
                  key=lambda kv: -kv[1])[:TOP]


def ranges(engine, targets: Dict[str, Tuple[str, str]], rounds: List[int],
           device) -> Dict[str, dict]:
    """Device seconds and calls of each module attribute of ``targets``
    over ``rounds``."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    if not targets:
        return {}

    def make(label, fn):
        def call(*a, **kw):
            with torch.profiler.record_function(f"portbench-range:{label}"):
                sync(device)
                out = fn(*a, **kw)
                sync(device)
            return out
        return call

    with patched(targets, make):
        sync(device)
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for rnd in rounds:
                engine.run_round(rnd)
                sync(device)
    events = prof.events()
    dev = _device_events(events)
    iv = np.array([[e.time_range.start, e.time_range.end] for e in dev],
                  float).reshape(-1, 2)
    out = {}
    for label in targets:
        marks = [e for e in events
                 if e.name == f"portbench-range:{label}"]
        busy = 0.0
        for m in marks:
            a, b = m.time_range.start, m.time_range.end
            u = _union(iv[(iv[:, 0] >= a) & (iv[:, 1] <= b)])
            busy += float((u[:, 1] - u[:, 0]).sum()) * 1e-6 if len(u) \
                else 0.0
        out[label] = {"calls": len(marks), "device_s": busy}
    return out


def needs(readers: dict) -> Tuple[List[str], Dict[str, Tuple[str, str]]]:
    """The span paths and ranges the cell's metric readers name."""
    paths: List[str] = []
    targets: Dict[str, Tuple[str, str]] = {}
    for mod in readers.values():
        for p in getattr(mod, "SPANS", ()):
            if p not in paths:
                paths.append(p)
        targets.update(getattr(mod, "RANGES", {}))
    return paths, targets


def read_metrics(readers: dict, ctx: Context) -> Dict[str, Optional[float]]:
    return {name: mod.read(ctx) for name, mod in readers.items()}
