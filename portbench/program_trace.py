"""The program's own spans over a sub-window of rounds: ``run_round``
under ``repro_torch.trace.recording()``, with no profiler and nothing
wrapped, each round ending in a synchronize as in the window.

``record`` returns the rounds, their wall seconds, per-span-name
``calls``, ``total_s`` and ``self_s``, the counters (``host_syncs.<site>``,
``kernels.<name>``), the syncs and the seconds spent in them, or {}
where the port has no tracer. It prints the recorded rounds' mean wall
time beside the window's: the tracer's cost when on. The readers of
``metrics/`` that set ``PROGRAM = True`` read it from ``ctx.program``
(a ``tracing.Context`` without it reads None).

Run alone, it reads where a cell's round goes from the program's spans:

    python3 portbench/program_trace.py --workload <cell> --seed <n> \\
        --seconds <s> [--profile]

set-up and the window as in a run, then the recorded sub-window (host
ms per span and family, syncs by site), one round under
``torch.cuda.set_sync_debug_mode("warn")`` (the card's own count of
blocking syncs beside the program's), and with ``--profile`` a few
rounds under ``torch.profiler``: the kernels launched and their device
ms under each program range. It prints them as one JSON line.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import sys
import time
import traceback
import warnings
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, TextIO

import numpy as np
import torch

SECONDS = 3.0      # the recorded sub-window, about this long, 3 to 50 rounds
PROFILE_ROUNDS = 3


def n_rounds(round_s: float) -> int:
    return max(3, min(50, int(SECONDS / round_s)))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _recorded(trace, engine, rounds: Iterable[int], device):
    times: List[float] = []
    with trace.recording() as rec:
        for rnd in rounds:
            t = time.perf_counter()
            engine.run_round(rnd)
            _sync(device)
            times.append(time.perf_counter() - t)
    return rec, times


def record(engine, rounds: Iterable[int], device, round_ms: float,
           err: TextIO = sys.stderr) -> dict:
    """The program's spans and counters over ``rounds``; {} where the
    port has no tracer."""
    try:
        from repro_torch import trace
    except ImportError:
        return {}
    rec, times = _recorded(trace, engine, rounds, device)
    print(f"portbench: program spans over {len(times)} rounds, "
          f"{1e3 * np.mean(times):.3f} ms a round recorded, the window "
          f"{round_ms:.3f}", file=err)
    return {"rounds": len(times), "seconds": float(np.sum(times)),
            "names": rec.names, "counters": rec.counters,
            "host_syncs": sum(rec.host_syncs().values()),
            "sync_s": sum(n["total_s"] for k, n in rec.names.items()
                          if k.startswith(trace.SYNC))}


def _program(ctx) -> Optional[dict]:
    p = getattr(ctx, "program", None)
    return p if p and p.get("rounds") else None


def self_ms(ctx, name: str) -> Optional[float]:
    """Self ms a round of the spans ``name``; None where there are none."""
    p = _program(ctx)
    if p is None or name not in p["names"]:
        return None
    return 1e3 * p["names"][name]["self_s"] / p["rounds"]


def syncs_per_round(ctx) -> Optional[float]:
    p = _program(ctx)
    return None if p is None else p["host_syncs"] / p["rounds"]


def sync_wait_ms(ctx) -> Optional[float]:
    p = _program(ctx)
    return None if p is None else 1e3 * p["sync_s"] / p["rounds"]


# -- run alone ----------------------------------------------------------------

def _by_family(rec, rounds: int) -> Dict[str, Dict[str, float]]:
    """Self ms a round of each span name, by the cohort it carries."""
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    child = defaultdict(int)
    for s in rec.spans:
        if s.parent is not None:
            child[s.parent] += s.end_ns - s.start_ns
    for i, s in enumerate(rec.spans):
        cohort = s.attrs.get("cohort")
        if cohort is not None:
            out[s.name][cohort] += (s.end_ns - s.start_ns - child[i]) \
                * 1e-6 / rounds
    return {k: dict(v) for k, v in out.items()}


def sync_debug_round(engine, rnd: int) -> dict:
    """One recorded round with the card warning at each blocking sync,
    each warning put in the program's sync span around it: the stacks of
    those no sync span holds (``stray``), the spans that hold more than
    one (``doubled``) or none (``empty``)."""
    from repro_torch import trace
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        seen.append((time.perf_counter_ns(), f"{filename}:{lineno}",
                     "".join(traceback.format_stack(limit=8)[:-1])))

    # turning the mode on warns once itself, before the warnings counted
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            with trace.recording() as rec:
                engine.run_round(rnd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [s for s in rec.spans if s.name.startswith(trace.SYNC)]
    held: List[List[str]] = [[] for _ in syncs]
    stray = []
    for t, place, stack in seen:
        inside = [i for i, s in enumerate(syncs)
                  if s.start_ns <= t <= s.end_ns]
        if inside:
            held[inside[-1]].append(place)
        else:
            stray.append(stack)
    return {"warnings": len(seen),
            "host_syncs": sum(rec.host_syncs().values()),
            "by_site": rec.host_syncs(), "stray": stray,
            "doubled": [(s.name, h) for s, h in zip(syncs, held)
                        if len(h) > 1],
            "empty": [s.name for s, h in zip(syncs, held) if not h]}


def _profiled(engine, rounds: List[int], names: Iterable[str]) -> dict:
    """A round's kernels under each program range, over ``rounds`` under
    the profiler: each launch (on any thread: the autograd engine's too)
    goes to the innermost range open on the host at that moment, and its
    kernel's device ms with it (matched by correlation id)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for rnd in rounds:
            engine.run_round(rnd)
            torch.cuda.synchronize()
    names = set(names)
    events = prof.profiler.kineto_results.events()
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    ranges = sorted((e for e in cpu if e.name() in names),
                    key=lambda e: e.start_ns())
    starts = [r.start_ns() for r in ranges]
    where: Dict[int, str] = {}
    out: Dict[str, dict] = defaultdict(lambda: {"launches": 0,
                                                "device_ms": 0.0})
    for e in cpu:
        if "LaunchKernel" not in e.name():
            continue
        t = e.start_ns()
        # the latest-opened range still open at t is the innermost
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ranges[i].end_ns() < t:
            i -= 1
        where[e.correlation_id()] = ranges[i].name() if i >= 0 else "-"
        out[where[e.correlation_id()]]["launches"] += 1
    matched = total = 0
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() \
                or e.name().startswith(("Memcpy", "Memset")):
            continue
        total += 1
        if e.correlation_id() in where:
            matched += 1
            out[where[e.correlation_id()]]["device_ms"] += \
                e.duration_ns() * 1e-6
    n = len(rounds)
    return {"kernels_matched": f"{matched}/{total}",
            "ranges": {k: {"launches": v["launches"] / n,
                           "device_ms": v["device_ms"] / n}
                       for k, v in sorted(out.items())}}


def main(argv: Optional[List[str]] = None) -> int:
    from portbench import check, harness, spec
    from portbench.inputs import make_inputs
    p = argparse.ArgumentParser(prog="portbench/program_trace.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--profile", action="store_true")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(harness.THREADS)
    inputs = make_inputs(cell.config, cell.traffic, args.seed, device,
                         cell.root)
    engine, _, _ = harness.set_up(cell, inputs, device)
    start = harness.warm(engine, check.CHECK_ROUNDS,
                         float(cell.config["warm_seconds"]), device)
    gc.collect()
    gc.freeze()
    win = harness.window(engine, start, args.seconds, device)
    round_ms = 1e3 * win["seconds"] / win["rounds"]
    rnd = win["next"]
    n = n_rounds(round_ms * 1e-3)
    from repro_torch import trace
    rec, times = _recorded(trace, engine, range(rnd, rnd + n), device)
    rnd += n
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0), "round_ms": round_ms,
           "window_rounds": win["rounds"], "recorded_rounds": n,
           "recorded_round_ms": 1e3 * float(np.mean(times)),
           "self_ms": {k: 1e3 * v["self_s"] / n for k, v in rec.names.items()},
           "total_ms": {k: 1e3 * v["total_s"] / n
                        for k, v in rec.names.items()},
           "calls": {k: v["calls"] / n for k, v in rec.names.items()},
           "by_family": _by_family(rec, n),
           "counters": {k: v / n for k, v in rec.counters.items()},
           "sync_debug": sync_debug_round(engine, rnd)}
    rnd += 1
    if args.profile:
        out["profile"] = _profiled(
            engine, list(range(rnd, rnd + PROFILE_ROUNDS)), rec.names)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:1] = [root, os.path.join(root, "src")]
    sys.exit(main())
