"""Run the port's synchronous federation from the shell, under SQMD or a
baseline (``--policy fedmd|ddist|isgd``).

  python -m repro_torch.launch.federate --device cuda --rounds 40
  python -m repro_torch.launch.federate --policy fedmd --interval 2
  python -m repro_torch.launch.federate --schedule staged-join \
      --dataset sc_like --device cpu
  python -m repro_torch.launch.federate --delta --selection ivf \
      --uplink int8 --device cuda

(with ``src`` on ``PYTHONPATH``). Prints per-eval accuracy, then a JSON
summary. ``--device`` defaults to ``cuda`` and fails without a card.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.core import (FederationConfig, FederationEngine, Protocol,
                              StagedJoin, as_codec, precision_recall,
                              registered_codecs)
from repro_torch.core.policies import registered_policies
from repro_torch.data import DATASETS, make_splits
from repro_torch.models import hetero_mlp_zoo


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--policy", choices=registered_policies(),
                    default="sqmd")
    ap.add_argument("--dataset", choices=tuple(DATASETS), default="pad_like")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--q", type=int, default=16)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--rho", type=float, default=0.8)
    ap.add_argument("--interval", type=int, default=1,
                    help="communication interval I: upload and fire the "
                         "server every I rounds")
    ap.add_argument("--schedule", choices=("always-on", "staged-join"),
                    default="always-on")
    ap.add_argument("--stages", type=int, default=3,
                    help="staged-join: number of equal join waves")
    ap.add_argument("--samples-per-client", type=int, default=60)
    ap.add_argument("--ref-size", type=int, default=120)
    ap.add_argument("--label-noise", type=float, default=0.3)
    ap.add_argument("--delta", action="store_true",
                    help="incremental O(u·N) server graph updates (vs the "
                         "full O(N^2) rebuild)")
    ap.add_argument("--selection", choices=("exact", "ivf"),
                    default="exact",
                    help="neighbor selection: the exact dense (N,N) "
                         "divergence or the approximate IVF top-K index "
                         "(requires --delta)")
    ap.add_argument("--uplink", default="dense32",
                    help="messenger wire codec, client->server "
                         f"({', '.join(registered_codecs())})")
    ap.add_argument("--downlink", default="dense32",
                    help="target wire codec, server->client (same names)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.rounds < 1:
        ap.error("--rounds must be >= 1")
    if args.interval < 1:
        ap.error("--interval must be >= 1")
    if args.selection == "ivf" and not args.delta:
        ap.error("--selection ivf requires --delta (the approximate index "
                 "only exists on the incremental graph path)")
    for which in ("uplink", "downlink"):
        try:
            as_codec(getattr(args, which))
        except (KeyError, ValueError) as e:
            ap.error(f"--{which}: {e}")

    ds = DATASETS[args.dataset](samples_per_client=args.samples_per_client,
                                ref_size=args.ref_size)
    splits = make_splits(ds, seed=args.seed, label_noise=args.label_noise)
    schedule = None
    if args.schedule == "staged-join":
        per = max(1, args.rounds // args.stages)
        schedule = StagedJoin([(i % args.stages) * per
                               for i in range(ds.n_clients)])
    protocol = Protocol(args.policy, rho=args.rho, q=args.q, k=args.k,
                        interval=args.interval)
    config = FederationConfig(rounds=args.rounds, batch_size=args.batch,
                              eval_every=args.eval_every,
                              delta_graph=args.delta,
                              selection=args.selection, uplink=args.uplink,
                              downlink=args.downlink, verbose=True)
    print(f"policy={args.policy} schedule={schedule or 'always-on'} "
          f"dataset={args.dataset} clients={ds.n_clients} "
          f"device={args.device} config={config}")
    t0 = time.time()
    engine = FederationEngine.build(
        ds, splits, hetero_mlp_zoo(ds.feature_len, ds.n_classes), None,
        protocol, config=config, schedule=schedule, seed=args.seed + 1,
        device=args.device)
    hist = engine.fit(splits)
    prec, rec = precision_recall(engine.fed, splits, ds.n_classes)
    summary = {
        "policy": args.policy, "interval": args.interval,
        "dataset": args.dataset,
        "schedule": args.schedule, "rounds": args.rounds,
        "delta": args.delta, "selection": args.selection,
        "uplink": args.uplink, "downlink": args.downlink,
        "device": str(engine.fed.device),
        "final_acc": hist.mean_acc[-1], "selected_acc": hist.selected_acc,
        "macro_precision": prec, "macro_recall": rec,
        "server_rounds": hist.server_rounds[-1],
        "staleness": hist.staleness[-1],
        "bytes_up": hist.bytes_up[-1], "bytes_down": hist.bytes_down[-1],
        "wall_s": round(time.time() - t0, 1),
    }
    if hist.graph_stats:
        summary["graph"] = hist.graph_stats[-1]
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
