"""Run the port's federation from the shell, under SQMD or a baseline
(``--policy fedmd|ddist|isgd``), on the round-synchronous clock or the
event clock.

  python -m repro_torch.launch.federate --device cuda --rounds 40
  python -m repro_torch.launch.federate --policy fedmd --interval 2
  python -m repro_torch.launch.federate --schedule dropout --dropout-p 0.3 \
      --local-steps 2 --dataset sc_like
  python -m repro_torch.launch.federate --delta --selection ivf \
      --uplink int8 --device cuda
  python -m repro_torch.launch.federate --dataset sc_like \
      --zoo mlp-s,resnet,transformer,ssm,rglru \
      --assignment mlp-s:0.3,resnet:0.3,transformer:0.2,ssm:0.1,rglru:0.1

Event clock (virtual-time async runtime):

  python -m repro_torch.launch.federate --clock event \
      --arrivals straggler-latency --latency 2.5 --trigger quorum
  python -m repro_torch.launch.federate --clock event \
      --arrivals bursty --trigger every-k --trigger-k 10 --until 60

Client-axis sharding (cohort steps, uploads and the server's divergence
rows split over a mesh; on the CPU, 8 entries of the CPU):

  python -m repro_torch.launch.federate --devices 2 --device cuda
  python -m repro_torch.launch.federate --devices 8 --device cpu

(with ``src`` on ``PYTHONPATH``). Prints per-eval accuracy, then a JSON
summary. ``--device`` defaults to ``cuda`` and fails without a card.
``--ckpt DIR`` saves the federation at the end as
``DIR/step_<rounds>.msgpack``, a file the reference's
``repro.checkpoint.restore_federation`` also reads.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Union

from repro_torch.checkpoint import save_federation
from repro_torch.core import (ArrivalProcess, AsyncFederationEngine,
                              BurstyArrivals, EveryKUploads,
                              FederationConfig, FederationEngine,
                              HeterogeneousCadence, Protocol, Quorum,
                              RandomDropout, Schedule, ScheduleArrivals,
                              StagedJoin, Straggler, StragglerLatency,
                              Trigger, WallInterval, as_codec, get_arrivals,
                              precision_recall, registered_arrivals,
                              registered_codecs, registered_schedules,
                              registered_triggers)
from repro_torch.core.policies import registered_policies
from repro_torch.data import DATASETS, make_splits
from repro_torch.models import (DEFAULT_ZOO, build_zoo, parse_assignment,
                                registered_families)


def make_schedule(args, n_clients: int, rounds: int) -> Optional[Schedule]:
    if args.schedule == "staged-join":
        per = max(1, rounds // args.stages)
        return StagedJoin([(i % args.stages) * per
                           for i in range(n_clients)])
    if args.schedule == "dropout":
        return RandomDropout(p=args.dropout_p, seed=args.seed)
    if args.schedule == "straggler":
        return Straggler(fraction=args.straggler_fraction,
                         period=args.straggler_period, seed=args.seed)
    return None  # always-on


def make_arrivals(args, n_clients: int, rounds: int) -> ArrivalProcess:
    if args.arrivals == "schedule":
        return ScheduleArrivals(make_schedule(args, n_clients, rounds))
    if args.arrivals == "straggler-latency":
        return StragglerLatency(fraction=args.straggler_fraction,
                                delay=args.latency, seed=args.seed)
    if args.arrivals == "cadence":
        return HeterogeneousCadence(fast=args.cadence_fast,
                                    slow=args.cadence_slow, seed=args.seed)
    if args.arrivals == "bursty":
        return BurstyArrivals(burst_every=args.burst_every,
                              jitter=args.latency, seed=args.seed)
    return get_arrivals(args.arrivals)()


def make_trigger(args) -> Union[str, Trigger]:
    if args.trigger == "every-k":
        return EveryKUploads(k=args.trigger_k)
    if args.trigger == "interval":
        return WallInterval(period=args.trigger_period)
    if args.trigger == "quorum":
        return Quorum(frac=args.quorum_frac)
    return args.trigger


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--policy", choices=registered_policies(),
                    default="sqmd")
    ap.add_argument("--dataset", choices=tuple(DATASETS), default="pad_like")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--q", type=int, default=16)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--rho", type=float, default=0.8)
    ap.add_argument("--interval", type=int, default=1,
                    help="communication interval I: upload and fire the "
                         "server every I rounds (sync clock only)")
    ap.add_argument("--schedule", choices=registered_schedules(),
                    default="always-on")
    ap.add_argument("--stages", type=int, default=3,
                    help="staged-join: number of equal join waves")
    ap.add_argument("--dropout-p", type=float, default=0.2)
    ap.add_argument("--straggler-fraction", type=float, default=0.3)
    ap.add_argument("--straggler-period", type=int, default=3)
    # --- event clock (async virtual-time runtime) ---
    ap.add_argument("--clock", choices=("sync", "event"), default="sync",
                    help="sync: round loop; event: virtual-clock runtime")
    ap.add_argument("--until", type=float,
                    help="event clock: virtual-time horizon "
                         "(default rounds-1)")
    ap.add_argument("--arrivals", choices=registered_arrivals(),
                    default="schedule",
                    help="event clock: client arrival/latency process "
                         "('schedule' shims --schedule)")
    ap.add_argument("--latency", type=float, default=2.0,
                    help="straggler-latency upload delay / bursty jitter")
    ap.add_argument("--cadence-fast", type=float, default=1.0)
    ap.add_argument("--cadence-slow", type=float, default=3.0)
    ap.add_argument("--burst-every", type=float, default=4.0)
    ap.add_argument("--trigger", choices=registered_triggers(),
                    default="every-upload",
                    help="event clock: when the server fires policy rounds")
    ap.add_argument("--trigger-k", type=int, default=8)
    ap.add_argument("--trigger-period", type=float, default=1.0)
    ap.add_argument("--quorum-frac", type=float, default=0.5)
    ap.add_argument("--zoo", default=",".join(DEFAULT_ZOO),
                    help="comma-separated model families "
                         f"({', '.join(registered_families())})")
    ap.add_argument("--assignment",
                    help="family per client: 'fam:w,...' weighted shares "
                         "(the paper's Table-I ratios) or 'fam,fam,...' "
                         "round-robin; default round-robins --zoo")
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
    ap.add_argument("--devices", type=int,
                    help="split the client axis over this many devices "
                         "(cohort steps, uploads, the server's divergence "
                         "rows): the first N cards, or N entries of the "
                         "CPU with --device cpu. Default: one device")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", help="save the federation into this "
                                   "directory at the end")
    args = ap.parse_args(argv)
    if args.rounds < 1:
        ap.error("--rounds must be >= 1")
    if args.interval < 1:
        ap.error("--interval must be >= 1")
    if args.local_steps < 1:
        ap.error("--local-steps must be >= 1")
    if args.devices is not None and args.devices < 1:
        ap.error("--devices must be >= 1")
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
    try:
        zoo = build_zoo(args.zoo, ds.feature_len, ds.n_classes)
        assignment = parse_assignment(args.assignment, list(zoo),
                                      ds.n_clients)
    except (KeyError, ValueError) as e:
        ap.error(str(e))
    protocol = Protocol(args.policy, rho=args.rho, q=args.q, k=args.k,
                        interval=args.interval)
    config = FederationConfig(rounds=args.rounds, batch_size=args.batch,
                              local_steps=args.local_steps,
                              eval_every=args.eval_every,
                              delta_graph=args.delta,
                              selection=args.selection, uplink=args.uplink,
                              downlink=args.downlink, devices=args.devices,
                              verbose=True)
    t0 = time.time()
    if args.clock == "event":
        arrivals = make_arrivals(args, ds.n_clients, args.rounds)
        trigger = make_trigger(args)
        print(f"policy={args.policy} clock=event arrivals={arrivals!r} "
              f"trigger={trigger!r} dataset={args.dataset} "
              f"clients={ds.n_clients} device={args.device} "
              f"config={config}")
        engine = AsyncFederationEngine.build(
            ds, splits, zoo, assignment, protocol, arrivals=arrivals,
            trigger=trigger, config=config, seed=args.seed + 1,
            device=args.device)
        hist = engine.fit(splits, until=args.until)
    else:
        schedule = make_schedule(args, ds.n_clients, args.rounds)
        print(f"policy={args.policy} schedule={schedule or 'always-on'} "
              f"dataset={args.dataset} clients={ds.n_clients} "
              f"device={args.device} config={config}")
        engine = FederationEngine.build(
            ds, splits, zoo, assignment, protocol, config=config,
            schedule=schedule, seed=args.seed + 1, device=args.device)
        hist = engine.fit(splits)
    prec, rec = precision_recall(engine.fed, splits, ds.n_classes)
    summary = {
        "policy": args.policy, "interval": args.interval,
        "dataset": args.dataset, "clock": args.clock,
        "rounds": args.rounds, "local_steps": args.local_steps,
        "delta": args.delta, "selection": args.selection,
        "uplink": args.uplink, "downlink": args.downlink,
        "device": str(engine.fed.device),
        "final_acc": hist.mean_acc[-1], "selected_acc": hist.selected_acc,
        "macro_precision": prec, "macro_recall": rec,
        "virtual_time": hist.times[-1],
        "server_rounds": hist.server_rounds[-1],
        "staleness": hist.staleness[-1],
        "bytes_up": hist.bytes_up[-1], "bytes_down": hist.bytes_down[-1],
        "wall_s": round(time.time() - t0, 1),
    }
    if args.clock == "event":
        summary["arrivals"] = repr(engine.arrivals)
        summary["trigger"] = repr(engine.bus.trigger)
    else:
        summary["schedule"] = args.schedule
    if hist.graph_stats:
        summary["graph"] = hist.graph_stats[-1]
    if args.devices:
        summary["devices"] = args.devices
    if args.zoo != ",".join(DEFAULT_ZOO):
        summary["zoo"] = args.zoo
    if args.assignment:
        summary["assignment"] = args.assignment
    if args.ckpt:
        save_federation(args.ckpt, engine.fed, step=args.rounds,
                        bus=engine.bus, clients=engine.clients)
        summary["ckpt"] = f"{args.ckpt}/step_{args.rounds}.msgpack"
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
