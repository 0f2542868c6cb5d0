"""Train-and-serve on the port: personalized queries answered while the
federation is still learning.

An ``AsyncFederationEngine`` runs the paper's asynchronous messenger
distillation on a virtual clock; a ``QueryRuntime`` rides the SAME event
loop, so query traffic interleaves with client wakes, messenger uploads,
and server policy fires. Every answer comes from the latest published
``SnapshotStore`` version of that client's own personalized params and
reports how stale those params were at serve time.

The demo contrasts two admission policies under one bursty diurnal
workload (identical arrivals, apples-to-apples):

  immediate  flush at every arrival instant — lowest wait, tiny batches
  micro      max-batch/max-wait micro-batching — batches amortize the
             gather-forward, the tail rides the max-wait bound

The latencies are the host's wall clock around each batch's forward plus
its virtual queue wait.

    PYTHONPATH=src python -m repro_torch.examples.train_and_serve \
        [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Mapping

from repro_torch import Device
from repro_torch.core import AsyncFederationEngine, FederationConfig, sqmd
from repro_torch.data import make_splits, sc_like
from repro_torch.models import hetero_mlp_zoo
from repro_torch.serve import (DiurnalQueries, Immediate, MicroBatch,
                               QueryRuntime, split_query_stream)

HEADER = (f"{'policy':<42}{'served':>7}{'p50 ms':>9}{'p99 ms':>9}"
          f"{'depth':>6}{'stale':>7}{'acc':>7}")


def summary_row(s: Mapping, acc: float) -> str:
    """One policy's row from ``QueryRuntime.summary``'s keys and the final
    mean test accuracy."""
    return (f"{s['policy']:<42}{s['n_served']:>7}"
            f"{s['latency_p50_s']*1e3:>9.1f}"
            f"{s['latency_p99_s']*1e3:>9.1f}"
            f"{s['queue_depth_max']:>6}"
            f"{s['staleness_mean']:>7.2f}"
            f"{acc:>7.3f}")


def run(*, device: Device = None, until: float = 24.0) -> dict:
    """Both admission policies on ``device`` (None: the card), each on a
    fresh federation to the horizon ``until``. Returns per policy the
    summary, the final accuracy, the History and the engine."""
    ds = sc_like(samples_per_client=40, ref_size=60)
    splits = make_splits(ds, seed=0, label_noise=0.3)
    zoo = hetero_mlp_zoo(ds.feature_len, ds.n_classes)
    assignment = [list(zoo)[i % 3] for i in range(ds.n_clients)]
    config = FederationConfig(rounds=int(until), batch_size=16,
                              eval_every=6)
    workload = DiurnalQueries(base_rate=0.4, amp=0.8, period=8.0,
                              burst_frac=0.5, seed=3)

    print(f"clients={ds.n_clients}  horizon={until}  workload={workload!r}")
    print(HEADER)
    out = {}
    for name, policy in (("immediate", Immediate(max_batch=64)),
                         ("micro", MicroBatch(max_batch=16, max_wait=0.25))):
        engine = AsyncFederationEngine.build(
            ds, splits, zoo, assignment, sqmd(q=16, k=8, rho=0.8),
            arrivals="cadence", trigger="every-k", config=config, seed=1,
            device=device)
        runtime = QueryRuntime(engine, workload=workload, policy=policy,
                               features=split_query_stream(splits))
        hist = runtime.run(splits, until=until)
        s = runtime.summary(horizon=until)
        print(summary_row(s, hist.mean_acc[-1]))
        out[name] = {"summary": s, "acc": hist.mean_acc[-1],
                     "history": hist, "engine": engine}
    print("\nsame traffic, same training run shape: immediate buys p50 "
          "at the cost of per-request compute;\nmicro batches the bursts "
          "and bounds the tail at max_wait + compute.")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
