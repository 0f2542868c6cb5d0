"""Asynchronous scenarios on the event-driven virtual-clock runtime
(paper §IV-F / Fig. 4 and beyond), on the port.

Part 1 — staged joins: three 'medical facilities' with different on-device
architectures join the federation at different virtual times (the classic
``StagedJoin`` schedule, shimmed into the event engine via
``ScheduleArrivals``). Watch: (a) newcomers are quality-filtered out of
the candidate pool until they mature, (b) converged M1 clients keep their
accuracy through each join under SQMD.

Part 2 — real lag, not masking: every client trains each tick, but a slow
fraction's messenger uploads arrive late (``StragglerLatency``) and the
server fires policy rounds only on a quorum of distinct uploaders. Stale
rows are merged, never dropped — the staleness histogram in ``History``
shows exactly how old the repository the dynamic graph grades over is.

    PYTHONPATH=src python -m repro_torch.examples.async_join [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np

from repro_torch import Device
from repro_torch.core import (AsyncFederationEngine, FederationConfig,
                              Quorum, ScheduleArrivals, StagedJoin,
                              StragglerLatency, fedmd, sqmd)
from repro_torch.data import make_splits, sc_like
from repro_torch.models import hetero_mlp_zoo

JOIN_HEADER = "t        overall   M1-only   srv-rounds  candidates"
STALE_HEADER = "t        acc      srv-rounds  stale-rows  mean-staleness"


def join_rows(hist, m1: np.ndarray) -> List[Tuple]:
    """Part 1's rows, one an eval: (t, overall accuracy, M1-only
    accuracy, server rounds, candidates or "-" before the first graph)."""
    return [(t, hist.mean_acc[i], float(hist.per_client_acc[i][m1].mean()),
             hist.server_rounds[i],
             hist.graph_stats[i]["n_candidates"]
             if i < len(hist.graph_stats) else "-")
            for i, t in enumerate(hist.times)]


def staleness_rows(hist) -> List[Tuple]:
    """Part 2's rows, one an eval: (t, accuracy, server rounds, stale
    repository rows, their mean staleness)."""
    return [(t, hist.mean_acc[i], hist.server_rounds[i],
             hist.staleness[i]["n_stale"], hist.staleness[i]["mean"])
            for i, t in enumerate(hist.times)]


def format_join_row(row: Tuple) -> str:
    t, acc, m1_acc, srv, ncand = row
    return (f"{t:6.1f}   {acc:.4f}    {m1_acc:.4f}    {srv:6d}      "
            f"{ncand}")


def format_staleness_row(row: Tuple) -> str:
    t, acc, srv, n_stale, mean = row
    return (f"{t:6.1f}   {acc:.4f}   {srv:6d}      {n_stale:4d}        "
            f"{mean:.2f}")


def run(*, device: Device = None, rounds: int = 45) -> dict:
    """Both parts on ``device`` (None: the card): the staged joins under
    sqmd and fedmd, then stragglers on a quorum. Returns each engine's
    rows, its bus counters, the History and the engine."""
    ds = sc_like(samples_per_client=60, ref_size=120)
    splits = make_splits(ds, seed=0, label_noise=0.3)
    zoo = hetero_mlp_zoo(ds.feature_len, ds.n_classes)
    fams = list(zoo)
    assignment = [fams[i % 3] for i in range(ds.n_clients)]
    stage_of = {fams[0]: 0, fams[1]: rounds // 3, fams[2]: 2 * rounds // 3}
    join = [stage_of[a] for a in assignment]
    m1 = np.asarray([a == fams[0] for a in assignment])
    config = FederationConfig(rounds=rounds, batch_size=16, eval_every=5)
    out = {}

    print("== Part 1: staged joins (schedule shim on the event clock) ==")
    for proto in (sqmd(q=16, k=8, rho=0.8), fedmd(rho=0.8)):
        engine = AsyncFederationEngine.build(
            ds, splits, zoo, assignment, proto,
            arrivals=ScheduleArrivals(StagedJoin(join)), seed=1,
            config=config, device=device)
        hist = engine.fit(splits, until=float(rounds - 1))
        rows = join_rows(hist, m1)
        m1_acc = [r[2] for r in rows]
        worst = min(m1_acc[len(m1_acc) // 3:])
        print(f"\n-- {proto.name} --")
        print(JOIN_HEADER)
        for row in rows:
            print(format_join_row(row))
        print(f"M1 worst accuracy after first join: {worst:.4f}")
        out[f"staged-{proto.name}"] = {
            "rows": rows, "m1_worst": worst, "n_uploads": engine.bus.n_uploads,
            "n_triggers": engine.bus.n_triggers, "history": hist,
            "engine": engine}

    print("\n== Part 2: straggler latency + quorum-triggered server ==")
    engine = AsyncFederationEngine.build(
        ds, splits, zoo, assignment, sqmd(q=16, k=8, rho=0.8),
        arrivals=StragglerLatency(fraction=0.3, delay=2.5, seed=1),
        trigger=Quorum(frac=0.5), seed=1, config=config, device=device)
    hist = engine.fit(splits, until=float(rounds - 1))
    rows = staleness_rows(hist)
    print(STALE_HEADER)
    for row in rows:
        print(format_staleness_row(row))
    print(f"uploads={engine.bus.n_uploads} server_rounds="
          f"{engine.bus.n_triggers} (quorum batches uploads; stale rows "
          f"merged, never dropped)")
    out["straggler-quorum"] = {
        "rows": rows, "n_uploads": engine.bus.n_uploads,
        "n_triggers": engine.bus.n_triggers, "history": hist,
        "engine": engine}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
