"""The port's tracer: host spans at its layer boundaries, and a count of
the host's blocking waits on the card, where they happen.

``span(name, **attrs)`` marks a stretch of host work. Its time is the
host's (``time.perf_counter_ns``) with no synchronize: the time the host
spends issuing that work, waits at a full launch queue or at a sync
inside it included. ``sync(site)`` is a span of its own kind, named
``sync.<site>``, around one operation that blocks the host until the
card has caught up (a pageable host-to-device copy, ``.cpu()``,
``.item()``, ``bool()`` of a device tensor, ``torch.nonzero``); a
recording counts it under ``host_syncs.<site>``. A site is counted
whenever the program passes it, on any device; on the card each pass
blocks.

``recording()`` turns recording on for its block and returns the
``Recording``: the spans in the order they opened, per-name ``calls``,
``total_s`` and ``self_s``, and the counters. Recordings do not nest and
nothing is written anywhere. Whenever ``torch.profiler`` is recording,
each span is also a ``record_function`` range, so the program's spans
lie on the profiler's timeline beside the kernels.

With neither on, ``span`` and ``sync`` return one shared no-op context:
no clock read, no span, no profiler range. The program is traced from
one thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

SYNC = "sync."          # prefix of a sync span's name
HOST_SYNCS = "host_syncs."
KERNELS = "kernels."

_OFF = contextlib.nullcontext()
_clock = time.perf_counter_ns


@dataclasses.dataclass
class Span:
    name: str
    parent: Optional[int]   # index in ``Recording.spans``; None at the top
    round: Optional[int]    # the enclosing ``round`` span's round
    attrs: dict
    start_ns: int
    end_ns: int = -1        # -1 while open

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclasses.dataclass
class Recording:
    """What one ``recording()`` block recorded. ``names`` and the
    ``kernels.<name>`` counters (launches of the hand kernels over the
    block, from ``kernels.ops.launch_counts``) are filled in when the
    block ends."""
    spans: List[Span] = dataclasses.field(default_factory=list)
    names: Dict[str, dict] = dataclasses.field(default_factory=dict)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    _open: List[int] = dataclasses.field(default_factory=list, repr=False)

    def host_syncs(self) -> Dict[str, int]:
        """Syncs by site."""
        return {k[len(HOST_SYNCS):]: v for k, v in self.counters.items()
                if k.startswith(HOST_SYNCS)}

    def _enter(self, name: str, attrs: dict, site: Optional[str]) -> int:
        parent = self._open[-1] if self._open else None
        rnd = attrs.get("round", None if parent is None
                        else self.spans[parent].round)
        if site is not None:
            key = HOST_SYNCS + site
            self.counters[key] = self.counters.get(key, 0) + 1
        self.spans.append(Span(name, parent, rnd, attrs, _clock()))
        self._open.append(len(self.spans) - 1)
        return self._open[-1]

    def _exit(self, index: int) -> None:
        self.spans[index].end_ns = _clock()
        self._open.pop()

    def _finish(self) -> None:
        child = [0] * len(self.spans)
        for s in self.spans:
            if s.parent is not None:
                child[s.parent] += s.end_ns - s.start_ns
        for s, c in zip(self.spans, child):
            n = self.names.setdefault(
                s.name, {"calls": 0, "total_s": 0.0, "self_s": 0.0})
            n["calls"] += 1
            n["total_s"] += s.seconds
            n["self_s"] += (s.end_ns - s.start_ns - c) * 1e-9


_active: Optional[Recording] = None


class _Span:
    __slots__ = ("name", "attrs", "site", "rec", "index", "range")

    def __init__(self, name: str, attrs: dict, site: Optional[str]):
        self.name, self.attrs, self.site = name, attrs, site

    def __enter__(self):
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.rec = _active
        if self.rec is not None:
            self.index = self.rec._enter(self.name, self.attrs, self.site)
        return self

    def __exit__(self, *exc) -> None:
        if self.rec is not None:
            self.rec._exit(self.index)
        if self.range is not None:
            self.range.__exit__(*exc)


def span(name: str, **attrs):
    """A context marking host work as ``name``; ``round=`` on a span is
    the round of every span under it."""
    if _active is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs, None)


def sync(site: str):
    """A context around one blocking wait on the card at ``site``."""
    if _active is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(SYNC + site, {}, site)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record every span and sync in the block; the ``Recording`` is
    complete when the block ends."""
    global _active
    from repro_torch.kernels import ops
    if _active is not None:
        raise RuntimeError("a recording is already on; recordings do not "
                           "nest")
    rec = Recording()
    before = ops.launch_counts()
    _active = rec
    try:
        yield rec
    finally:
        _active = None
        rec._finish()
        for name, n in ops.launch_counts().items():
            if n != before[name]:
                rec.counters[KERNELS + name] = n - before[name]
