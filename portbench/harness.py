"""One run of one cell: set-up, the measured window, the traced
sub-windows, the output check, the result line.

Set-up makes the inputs from the seed, builds the port's engine once and
drives it through its first rounds with ``run_round``, the call the
window times: the first ``check.CHECK_ROUNDS`` are copied out for the
output check, and further rounds warm up for the configuration's
``warm_seconds``; the collector then runs and freezes what set-up left.
The window then runs ``run_round`` back to back, each round ending in a
synchronize, for ``--seconds``; nothing else is timed. Once it has
closed, the peak memory is read, the engine is freed, and the plain
reference replays the checked rounds and judges them; ``main`` then
prints the result only if the process holds no JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Dict, List, Optional, TextIO

import numpy as np
import torch

from portbench import check, peaks, program, spec, tracing
from portbench.inputs import make_inputs

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names
THREADS = 4
SPAN_SECONDS = 3.0         # spans over about this long, 3 to 50 rounds
PROFILE_SECONDS = 1.0      # the profiler over about this long, 2 to 10
RANGE_ROUNDS = 2


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name (before the first dot) is
    JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def window(engine, start: int, seconds: float, device) -> dict:
    """``run_round`` back to back from round ``start`` until ``seconds``
    have passed; each round's wall time ends in a synchronize."""
    times: List[float] = []
    rnd = start
    t0 = time.perf_counter()
    end = t0
    while not times or end - t0 < seconds:
        s = time.perf_counter()
        engine.run_round(rnd)
        tracing.sync(device)
        end = time.perf_counter()
        times.append(end - s)
        rnd += 1
    return {"rounds": len(times), "seconds": end - t0, "times": times,
            "next": rnd}


def _between(lo: int, hi: int, value: float) -> int:
    return max(lo, min(hi, int(value)))


def end_to_end(cell: spec.Cell, win: dict, setup_s: float,
               peak: int) -> Dict[str, dict]:
    values = {"round_ms": 1e3 * win["seconds"] / win["rounds"],
              "peak_mem_gib": peak / 2 ** 30,
              "setup_s": setup_s}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def traced(cell: spec.Cell, engine, inputs, win: dict, device,
           device_name: str) -> tuple:
    """(per-layer metrics, profile) of a ``--trace 1`` run."""
    readers = spec.metric_readers(cell)
    paths, targets = tracing.needs(readers)
    round_s = win["seconds"] / win["rounds"]
    ctx = tracing.Context(config=cell.config, n_clients=inputs.n_clients,
                        ref_size=len(inputs.ref_y),
                        n_classes=inputs.n_classes, length=inputs.in_dim,
                        peaks=peaks.peaks(device_name),
                        window={"rounds": win["rounds"],
                                "seconds": win["seconds"]},
                        awake_share=float(np.mean([
                            inputs.available(r).mean()
                            for r in range(win["next"] - win["rounds"],
                                           win["next"])])))
    rnd = win["next"]
    n = _between(3, 50, SPAN_SECONDS / round_s)
    ctx.spans = tracing.spans(engine, paths, range(rnd, rnd + n), device)
    ctx.span_rounds = n
    rnd += n
    n = _between(2, 10, PROFILE_SECONDS / round_s)
    ctx.profile = tracing.profile(engine, paths, list(range(rnd, rnd + n)),
                                device)
    rnd += n
    ctx.ranges = tracing.ranges(engine, targets,
                              list(range(rnd, rnd + RANGE_ROUNDS)), device)
    metrics = {}
    for name, value in tracing.read_metrics(readers, ctx).items():
        if value is not None:
            unit = next(m["unit"] for m in cell.per_layer
                        if m["name"] == name)
            metrics[name] = {"value": value, "unit": unit}
    return metrics, ctx.profile


def set_up(cell: spec.Cell, inputs, device) -> tuple:
    """(engine, what its checked rounds produced, seconds spent copying
    that out): the engine built and driven through the checked rounds."""
    engine = program.build(inputs, device, cell.root)
    judge: dict = {"rounds": []}
    copy_s = 0.0
    last = check.CHECK_ROUNDS - 1
    for rnd in range(check.CHECK_ROUNDS):
        engine.run_round(rnd)
        tracing.sync(device)
        t = time.perf_counter()
        judge["rounds"].append(program.read_round(engine))
        if rnd in (0, last):
            clients = program.read_clients(engine, cell.config, cell.root)
            if rnd == 0:
                judge["grad1"] = {f: d["momentum"]
                                  for f, d in clients.items()}
            if rnd == last:
                judge["final"] = {f: d["params"] for f, d in clients.items()}
        copy_s += time.perf_counter() - t
    return engine, judge, copy_s


def warm(engine, start: int, seconds: float, device) -> int:
    """``run_round`` from round ``start`` until ``seconds`` have passed;
    the next round."""
    t0 = time.perf_counter()
    rnd = start
    while time.perf_counter() - t0 < seconds:
        engine.run_round(rnd)
        tracing.sync(device)
        rnd += 1
    return rnd


def run(cell: spec.Cell, seed: int, seconds: float, trace_on: bool,
        device="cuda", started: Optional[float] = None,
        err: TextIO = sys.stderr, threads: int = THREADS) -> dict:
    """The result line's object."""
    started = time.perf_counter() if started is None else started
    cuda = torch.device(device).type == "cuda"
    if cell.config["precision"] != "fp32":
        raise ValueError("the harness runs fp32 configurations")
    # fp32 as the configuration states it: no TF32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(threads)
    t_in = time.perf_counter()
    inputs = make_inputs(cell.config, cell.traffic, seed, device, cell.root)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_built = time.perf_counter()
    engine, judge, copy_s = set_up(cell, inputs, device)
    t_checked = time.perf_counter()
    start = warm(engine, check.CHECK_ROUNDS,
                 float(cell.config["warm_seconds"]), device)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - started - copy_s
    print(f"portbench: set-up {setup_s:.3f} s: to the inputs "
          f"{t_in - started:.3f}, inputs {t_built - t_in:.3f}, engine and "
          f"checked rounds {t_checked - t_built - copy_s:.3f} (copying "
          f"them out {copy_s:.3f} more), warm-up "
          f"{time.perf_counter() - t_checked:.3f} "
          f"({start - check.CHECK_ROUNDS} rounds)", file=err)
    win = window(engine, start, seconds, device)
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    metrics, prof = (traced(cell, engine, inputs, win, device, name)
                     if trace_on else ({}, {}))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if not trace_on:
        metrics = end_to_end(cell, win, setup_s, peak)
    del engine
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    _, nums = check.replay(inputs, device, judge=judge, root=cell.root)
    tenth = max(1, win["rounds"] // 10)
    print(f"portbench: window {win['seconds']:.3f} s, {win['rounds']} "
          f"rounds (first tenth {1e3 * np.mean(win['times'][:tenth]):.3f} "
          f"ms a round, last {1e3 * np.mean(win['times'][-tenth:]):.3f}); "
          f"reference {time.perf_counter() - t_ref:.3f} s", file=err)
    correct, shown = check.verdict(nums, cell.limits)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": win["rounds"], "failed": 0,
              "metrics": metrics, "device": dev}
    if trace_on:
        dev["busy_s"] = prof.get("busy_s", 0.0)
        dev["window_s"] = prof.get("window_s", 0.0)
        result["breakdown"] = {"device_ops": prof.get("device_ops", []),
                               "idle_gaps": prof.get("idle_gaps", [])}
    print(f"portbench: leaves left out of the change: "
          f"{int(nums.get('leaves_left_out', 0))}", file=err)
    for k, v in shown.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=err)
    result["checked"] = shown
    return result


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: List[str], started: Optional[float] = None) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 started=started)
    # after the window and the check, in the process that prints
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
