"""Train-and-serve from the shell: queries contend with training on one
virtual clock.

An ``AsyncFederationEngine`` runs the paper's asynchronous federation
while a ``QueryRuntime`` drives personalized inference traffic through
the same event loop: every answer comes from the latest published
snapshot of that client's personalized params and reports its staleness.

  python -m repro_torch.launch.serve_federation --until 20 \
      --query-arrivals query-poisson --query-rate 0.5

Bursty peak-hour traffic against micro-batching admission:

  python -m repro_torch.launch.serve_federation --until 24 \
      --query-arrivals query-diurnal --query-rate 0.4 --burst-frac 0.5 \
      --batch-policy micro --max-batch 16 --max-wait 0.25

(with ``src`` on ``PYTHONPATH``). ``--device`` defaults to ``cuda`` and
fails without a card.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.core import (AsyncFederationEngine, FederationConfig,
                              Protocol, get_arrivals, registered_arrivals,
                              registered_triggers)
from repro_torch.core.policies import registered_policies
from repro_torch.data import DATASETS, make_splits
from repro_torch.launch.federate import make_arrivals, make_trigger
from repro_torch.models import (DEFAULT_ZOO, build_zoo, parse_assignment,
                                registered_families)
# importing the package registers the query arrivals and batch policies
from repro_torch.serve import (DiurnalQueries, PoissonQueries, QueryRuntime,
                               get_batch_policy, registered_batch_policies,
                               split_query_stream)


def make_query_workload(args):
    """Query ArrivalProcess from CLI knobs (any registered name works;
    the query-* processes get their rate/shape arguments wired)."""
    if args.query_arrivals == "query-poisson":
        return PoissonQueries(rate=args.query_rate, seed=args.query_seed)
    if args.query_arrivals == "query-diurnal":
        return DiurnalQueries(base_rate=args.query_rate,
                              amp=args.query_amp,
                              period=args.query_period,
                              burst_frac=args.burst_frac,
                              seed=args.query_seed)
    return get_arrivals(args.query_arrivals)()


def make_batch_policy(args):
    cls = get_batch_policy(args.batch_policy)
    if args.batch_policy == "immediate":
        return cls(max_batch=args.max_batch)  # max_wait pinned to 0
    return cls(max_batch=args.max_batch, max_wait=args.max_wait)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    # --- training side (mirrors launch.federate's event clock) ---
    ap.add_argument("--policy", choices=registered_policies(),
                    default="sqmd")
    ap.add_argument("--dataset", choices=tuple(DATASETS), default="pad_like")
    ap.add_argument("--until", type=float, default=20.0,
                    help="virtual-time horizon for the shared event loop")
    ap.add_argument("--rounds", type=int, default=40,
                    help="eval cadence bookkeeping (horizon rules the run)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--devices", type=int,
                    help="split the client axis over this many devices; "
                         "snapshots copy the real rows to --device")
    ap.add_argument("--uplink", default="dense32")
    ap.add_argument("--downlink", default="dense32")
    ap.add_argument("--rho", type=float, default=0.8)
    ap.add_argument("--q", type=int, default=16)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--interval", type=int, default=1)
    ap.add_argument("--arrivals", choices=registered_arrivals(),
                    default="cadence",
                    help="training-side client arrival process")
    ap.add_argument("--latency", type=float, default=2.0)
    ap.add_argument("--cadence-fast", type=float, default=1.0)
    ap.add_argument("--cadence-slow", type=float, default=3.0)
    ap.add_argument("--burst-every", type=float, default=4.0)
    ap.add_argument("--straggler-fraction", type=float, default=0.3)
    ap.add_argument("--trigger", choices=registered_triggers(),
                    default="every-k")
    ap.add_argument("--trigger-k", type=int, default=8)
    ap.add_argument("--trigger-period", type=float, default=1.0)
    ap.add_argument("--quorum-frac", type=float, default=0.5)
    # --- serving side ---
    ap.add_argument("--query-arrivals", choices=registered_arrivals(),
                    default="query-poisson",
                    help="query traffic process (who asks, and when)")
    ap.add_argument("--query-rate", type=float, default=0.5,
                    help="queries per client per virtual second "
                         "(base rate for query-diurnal)")
    ap.add_argument("--query-amp", type=float, default=0.8,
                    help="query-diurnal: sinusoidal modulation depth")
    ap.add_argument("--query-period", type=float, default=8.0,
                    help="query-diurnal: virtual seconds per cycle")
    ap.add_argument("--burst-frac", type=float, default=0.0,
                    help="query-diurnal: fraction of clients querying "
                         "together at every peak")
    ap.add_argument("--query-seed", type=int, default=0)
    ap.add_argument("--batch-policy",
                    choices=registered_batch_policies(), default="micro")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait", type=float, default=0.25,
                    help="micro-batching: longest a request may wait "
                         "before a partial batch releases")
    ap.add_argument("--bucket-floor", type=int, default=1)
    ap.add_argument("--max-bucket", type=int, default=128)
    # --- data / misc ---
    ap.add_argument("--zoo", default=",".join(DEFAULT_ZOO),
                    help="comma-separated model families "
                         f"({', '.join(registered_families())})")
    ap.add_argument("--assignment",
                    help="family per client: 'fam:w,...' weighted or "
                         "'fam,fam,...' round-robin; default round-robins "
                         "--zoo")
    ap.add_argument("--samples-per-client", type=int, default=60)
    ap.add_argument("--ref-size", type=int, default=120)
    ap.add_argument("--label-noise", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--json", help="write the summary to this path "
                                   "(always printed to stdout too)")
    # reuse make_arrivals's schedule shim attributes
    ap.set_defaults(schedule="always-on", stages=3, dropout_p=0.2,
                    straggler_period=3)
    args = ap.parse_args(argv)
    if args.until <= 0:
        ap.error("--until must be > 0")
    if args.devices is not None and args.devices < 1:
        ap.error("--devices must be >= 1")

    ds = DATASETS[args.dataset](samples_per_client=args.samples_per_client,
                                ref_size=args.ref_size)
    splits = make_splits(ds, seed=args.seed, label_noise=args.label_noise)
    try:
        zoo = build_zoo(args.zoo, ds.feature_len, ds.n_classes)
        assignment = parse_assignment(args.assignment, list(zoo),
                                      ds.n_clients)
    except (KeyError, ValueError) as e:
        ap.error(str(e))

    protocol = Protocol(args.policy, rho=args.rho, q=args.q, k=args.k,
                        interval=args.interval)
    config = FederationConfig(rounds=args.rounds, batch_size=args.batch,
                              eval_every=args.eval_every,
                              uplink=args.uplink, downlink=args.downlink,
                              devices=args.devices)
    arrivals = make_arrivals(args, ds.n_clients, args.rounds)
    trigger = make_trigger(args)
    engine = AsyncFederationEngine.build(
        ds, splits, zoo, assignment, protocol, arrivals=arrivals,
        trigger=trigger, config=config, seed=args.seed + 1,
        device=args.device)
    runtime = QueryRuntime(engine,
                           workload=make_query_workload(args),
                           policy=make_batch_policy(args),
                           features=split_query_stream(splits),
                           bucket_floor=args.bucket_floor,
                           max_bucket=args.max_bucket)
    print(f"policy={args.policy} arrivals={arrivals!r} "
          f"trigger={trigger!r} workload={runtime.workload!r} "
          f"batch_policy={runtime.queue.policy!r} "
          f"clients={ds.n_clients} until={args.until} "
          f"device={args.device}")
    t0 = time.time()
    hist = runtime.run(splits, until=args.until)
    summary = {
        "policy": args.policy, "dataset": args.dataset,
        "until": args.until, "clients": ds.n_clients,
        "device": str(engine.fed.device),
        "final_acc": hist.mean_acc[-1],
        "server_rounds": hist.server_rounds[-1],
        "train_staleness": hist.staleness[-1],
        "serving": runtime.summary(horizon=args.until),
        "wall_s": round(time.time() - t0, 1),
    }
    if args.devices:
        summary["devices"] = args.devices
    text = json.dumps(summary, indent=2)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(text + "\n")
    print(text)
    return summary


if __name__ == "__main__":
    main()
