"""The readings the output check's limits are set from, on the card at a
cell's own size (not part of a benchmark run):

    python3 portbench/calibrate.py --workload <cell> \
        --sound <seed> ... --control <seed> ... [--out FILE]

* sound: the port as a run drives it (set-up's checked rounds), judged
  by the fp32 reference, one seed after another in one process;
* control: the reference computed in TF32, put in the port's place;
* witness (``--witness``): the port and the fp32 reference, each judged
  by the reference in fp64, so a gap that fp32 itself makes shows as such;
* faults: the reference with one of ``check.FAULTS`` planted (a step
  that leaves its state unchanged, half of each batch left out of the
  cross-entropy, one client's answer altered where it is produced), put
  in the port's place, on the control's seeds.

For each number the lower reading is the largest sound one; the upper
the smallest control reading if it is three times the lower or more,
and the smallest reading of each fault that is ten times the lower or
more (a state left unchanged: three times), the least of these. The
limit proposed lies between, nearer the upper: lower^0.4 upper^0.6,
the lower taken no smaller than fp32's unit round-off. The regret's
lower is taken no smaller than the largest sound divergence gap: a
near-tie between two neighbours is decided by the divergence's own
rounding, so a sound run's regret can reach that gap on a seed the
readings did not have.
"""
import os
import sys

if __name__ == "__main__":
    # the checkout and the port's source, in place of this folder
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:1] = [ROOT, os.path.join(ROOT, "src")]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from portbench import check, harness, spec  # noqa: E402
from portbench.inputs import make_inputs  # noqa: E402

FP32_ROUNDOFF = 2.0 ** -24


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def sound(cell, seed: int, device) -> dict:
    inputs = make_inputs(cell.config, cell.traffic, seed, device, cell.root)
    engine, judge, _ = harness.set_up(cell, inputs, device)
    del engine
    _free(device)
    trail: list = []
    nums = check.replay(inputs, device, judge=judge, root=cell.root,
                        trail=trail)[1]
    return {**nums, "trail": trail}


def planted(cell, seed: int, device, precision="fp32", fault=None) -> dict:
    inputs = make_inputs(cell.config, cell.traffic, seed, device, cell.root)
    obs, _ = check.replay(inputs, device, precision=precision, fault=fault,
                          root=cell.root)
    _free(device)
    return check.replay(inputs, device, judge=obs, root=cell.root)[1]


def witness(cell, seed: int, device) -> dict:
    """The port and the fp32 reference, each judged by the reference in
    fp64, round by round: where both read alike, fp32 itself is the
    cause of a gap, not the port."""
    inputs = make_inputs(cell.config, cell.traffic, seed, device, cell.root)
    engine, judge, _ = harness.set_up(cell, inputs, device)
    del engine
    _free(device)
    obs32, _ = check.replay(inputs, device, root=cell.root)
    out = {}
    for tag, got in (("port", judge), ("fp32_reference", obs32)):
        trail: list = []
        nums = check.replay(inputs, device, judge=got, root=cell.root,
                            precision="fp64", trail=trail)[1]
        out[tag] = {**nums, "trail": trail}
    return out


def limits(readings: dict) -> dict:
    out = {}
    for name in check.NUMBERS:
        lower = max(r[name] for r in readings["sound"])
        if name == "select_regret":
            lower = max(lower, max(r["div_max"] for r in readings["sound"]))
        uppers = {}
        for what in ("control",) + check.FAULTS:
            got = min(r[name] for r in readings[what])
            factor = 10 if what in ("half_batch", "answer") else 3
            if got > 0 and got >= factor * lower:
                uppers[what] = got
        upper = min(uppers.values()) if uppers else None
        lim = None
        if upper is not None and math.isfinite(upper) and upper > 0:
            lo = max(lower, FP32_ROUNDOFF)
            lim = float(f"{lo ** 0.4 * upper ** 0.6:.2g}")
        out[name] = {"lower": lower, "upper": upper, "by": uppers,
                     "limit": lim}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--sound", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, nargs="+", required=True)
    p.add_argument("--witness", type=int, nargs="*", default=[],
                   help="seeds to judge by the fp64 reference as well")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(harness.THREADS)
    readings = {"sound": [], "control": [], **{f: [] for f in check.FAULTS}}
    seeds = {"sound": args.sound, "control": args.control}
    t0 = time.perf_counter()
    for seed in args.sound:
        readings["sound"].append(sound(cell, seed, args.device))
        print(f"sound {seed} {readings['sound'][-1]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for seed in args.control:
        readings["control"].append(planted(cell, seed, args.device, "tf32"))
        print(f"control {seed} {readings['control'][-1]}", flush=True)
        for fault in check.FAULTS:
            readings[fault].append(planted(cell, seed, args.device,
                                           fault=fault))
            print(f"{fault} {seed} {readings[fault][-1]}", flush=True)
    witnessed = {seed: witness(cell, seed, args.device)
                 for seed in args.witness}
    for seed, w in witnessed.items():
        print(f"witness {seed} {w}", flush=True)
    out = {"workload": args.workload, "seeds": seeds, "readings": readings,
           "witness": witnessed,
           "limits": limits(readings),
           "device": torch.cuda.get_device_name(0)
           if torch.device(args.device).type == "cuda" else "cpu",
           "seconds": time.perf_counter() - t0}
    for name, v in out["limits"].items():
        print(f"{name}: lower {v['lower']!r} upper {v['upper']!r} "
              f"({v['by']}) limit {v['limit']!r}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
