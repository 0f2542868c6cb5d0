"""The per-entry-point cost table and the symbolic scaling fits.

``cost_table`` interprets every parameterized entry at the reference
dims; ``scaling_report`` re-traces each entry along its scale axis
(``entries.SCALE_AXES``) and fits the leading exponent of flops, bytes
and temp_bytes. Two estimators a metric:

  * ``fit``     — least-squares slope over the whole log-log sweep
  * ``leading`` — slope between the two LARGEST sizes, the asymptotic
                  leading-order estimate (the ``superlinear-memory`` rule
                  judges ``leading``)

Each (entry, dims) pair is traced once a run: the table's reference dims
are a point of most sweeps. The traces run in ``WORKERS`` Python
processes (``python -m repro_torch.analysis.cost.model``: pickled pairs
in, their results out, one at a time): a fake-tensor trace is ~2 ms an
aten op of Python, and the zoo's cohort steps have hundreds of ops at
each of four sizes. A pair's result is its ``CostSummary`` and its blowup
candidates, cached on the ``AnalysisContext`` so the cost rules share
one pass.
"""
from __future__ import annotations

import collections
import math
import os
import pickle
import subprocess
import sys
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.cost import entries as entries_mod
from repro_torch.analysis.cost import interp

# the metrics budgets and scaling fits cover
METRICS = ("flops", "bytes", "temp_bytes")
# processes the traces run in, and the fewest pending traces worth them
WORKERS = os.cpu_count() or 1
MIN_PARALLEL = 8
# blowup candidates a trace keeps: the policy (budgets' "blowup") filters
# them further, so it may be no looser than this scan
SCAN_RATIO, SCAN_FLOOR = 2.0, 1024

Key = Tuple[str, Tuple[Tuple[str, int], ...]]


def _key(name: str, overrides: Dict[str, int]) -> Key:
    """A (name, dims) pair with the overrides that equal the reference
    dims dropped, so a sweep point at the reference dims is the table's
    trace."""
    return name, tuple(sorted((k, v) for k, v in overrides.items()
                              if entries_mod.DEFAULT_DIMS.get(k) != v))


def _price(key: Key) -> Tuple[interp.CostSummary, List[interp.Blowup]]:
    name, overrides = key
    gm = entries_mod.trace_entry(name, **dict(overrides))
    return (interp.summarize(gm),
            interp.find_blowups(gm, SCAN_RATIO, SCAN_FLOOR))


def _send(stream, obj) -> None:
    data = pickle.dumps(obj)
    stream.write(len(data).to_bytes(8, "little") + data)
    stream.flush()


def _receive(stream):
    """One length-prefixed pickle from ``stream``, or None at its end."""
    head = stream.read(8)
    if len(head) < 8:
        return None
    return pickle.loads(stream.read(int.from_bytes(head, "little")))


def _price_in_workers(todo: List[Key]) -> list:
    """``_price`` of every key in WORKERS processes, each fed one key at a
    time from a shared queue, the zoo's cohort steps (hundreds of ops
    each) first, so no worker is left with a long tail."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path
                                                       if p))
    queue = collections.deque(sorted(
        todo, key=lambda k: not k[0].startswith("cohort_step[")))
    lock = threading.Lock()
    got: Dict[Key, tuple] = {}

    def worker() -> None:
        with tempfile.TemporaryFile() as err:
            proc = subprocess.Popen([sys.executable, "-m", __name__],
                                    stdin=subprocess.PIPE,
                                    stdout=subprocess.PIPE, stderr=err,
                                    env=env)
            try:
                while True:
                    with lock:
                        key = queue.popleft() if queue else None
                    if key is None:
                        break
                    _send(proc.stdin, key)
                    result = _receive(proc.stdout)
                    if result is None:
                        proc.wait()
                        err.seek(0)
                        raise RuntimeError(
                            f"cost worker failed (exit {proc.returncode}) "
                            f"on {key}:\n{err.read().decode()[-4000:]}")
                    got[key] = result
            finally:
                proc.stdin.close()
                proc.wait()

    with ThreadPoolExecutor(WORKERS) as ex:
        for f in [ex.submit(worker) for _ in range(WORKERS)]:
            f.result()
    return [got[k] for k in todo]


def priced(ctx, keys: Iterable[Key]
           ) -> Dict[Key, Tuple[interp.CostSummary, List[interp.Blowup]]]:
    """Every key's (summary, blowup candidates), each traced once: cached
    on ``ctx`` when given, the missing ones traced in parallel."""
    cache = ctx.cache.setdefault("cost_priced", {}) if ctx is not None \
        else {}
    todo = sorted({k for k in keys if k not in cache})
    if len(todo) >= MIN_PARALLEL and WORKERS > 1:
        cache.update(zip(todo, _price_in_workers(todo)))
    else:
        cache.update((k, _price(k)) for k in todo)
    return cache


def _all_keys() -> List[Key]:
    keys = [_key(name, {}) for name in entries_mod.entry_names()]
    for name, (axis, values) in entries_mod.SCALE_AXES.items():
        keys += [_key(name, {axis: v}) for v in values]
    return keys


def cost_table(ctx=None, dims: Optional[Dict[str, int]] = None
               ) -> Dict[str, interp.CostSummary]:
    """Entry name -> CostSummary at the reference dims (or ``dims``). The
    first call on a context prices the scaling sweeps too, in the same
    parallel pass."""
    overrides = dims or {}
    keys = {name: _key(name, overrides)
            for name in entries_mod.entry_names()}
    got = priced(ctx, list(keys.values()) + (_all_keys() if not dims
                                             else []))
    return {name: got[k][0] for name, k in keys.items()}


def blowup_candidates(ctx=None) -> Dict[str, List[interp.Blowup]]:
    """Entry name -> its blowup candidates at the reference dims."""
    keys = {name: _key(name, {}) for name in entries_mod.entry_names()}
    got = priced(ctx, list(keys.values()) + _all_keys())
    return {name: got[k][1] for name, k in keys.items()}


def leading_exponent(xs, ys) -> float:
    """Slope between the two largest samples (see module docstring)."""
    if len(xs) < 2:
        raise ValueError("need >= 2 scale samples")
    return (math.log(max(float(ys[-1]), 1.0) / max(float(ys[-2]), 1.0))
            / math.log(float(xs[-1]) / float(xs[-2])))


def scaling_report(ctx=None) -> Dict[str, dict]:
    """Entry name -> {axis, values, metric: {fit, leading, samples}}."""
    got = priced(ctx, _all_keys())
    report: Dict[str, dict] = {}
    for name, (axis, values) in entries_mod.SCALE_AXES.items():
        sums = [got[_key(name, {axis: v})][0] for v in values]
        rec: dict = {"axis": axis, "values": list(values)}
        for m in METRICS:
            ys = [getattr(s, m) for s in sums]
            rec[m] = {"fit": interp.fit_exponent(values, ys),
                      "leading": leading_exponent(values, ys),
                      "samples": ys}
        report[name] = rec
    return report


def format_table(table: Dict[str, interp.CostSummary],
                 scaling: Optional[Dict[str, dict]] = None) -> str:
    """Human-readable cost table (the ``--cost-table`` CLI view)."""
    lines = [f"{'entry':34s} {'flops':>11s} {'bytes':>11s} "
             f"{'peak':>11s} {'temp':>11s}  scaling(leading)"]
    for name in sorted(table):
        s = table[name]
        tail = ""
        if scaling and name in scaling:
            rec = scaling[name]
            tail = "  " + " ".join(
                f"{m}~{rec['axis']}^{rec[m]['leading']:.2f}"
                for m in METRICS)
        lines.append(f"{name:34s} {s.flops:11.3e} {s.bytes:11.3e} "
                     f"{s.peak_bytes:11.3e} {s.temp_bytes:11.3e}{tail}")
    return "\n".join(lines)


if __name__ == "__main__":
    # a worker of _price_in_workers: keys in, their results out, one at a
    # time, until its input closes
    while (key := _receive(sys.stdin.buffer)) is not None:
        _send(sys.stdout.buffer, _price(key))
