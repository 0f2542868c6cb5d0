"""End-to-end driver on the port: a full SQMD federation with the paper's
OWN client architectures (ResNet-1D 8/20/50), checkpointing, protocol
comparison, and per-round metrics through an engine callback.

Uses the ``FederationEngine`` API: the policy is looked up by name, so
any registered strategy works via --protocol. The checkpoint is the
reference's msgpack format: either package restores it.

    PYTHONPATH=src python -m repro_torch.examples.train_sqmd_federation \
        [--rounds 40] [--protocol sqmd|fedmd|ddist|isgd] [--resnet] \
        [--ckpt runs/federation_ckpt] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Mapping, Optional, Sequence

from repro_torch import Device
from repro_torch.checkpoint import save_federation
from repro_torch.core import (FederationConfig, FederationEngine, ddist,
                              fedmd, isgd, precision_recall, sqmd)
from repro_torch.data import make_splits, sc_like
from repro_torch.models import (RESNET8, RESNET20, RESNET50, hetero_mlp_zoo,
                                resnet1d_family)

PROTOS = {
    "sqmd": lambda: sqmd(q=16, k=8, rho=0.8),
    "fedmd": lambda: fedmd(rho=0.8),
    "ddist": lambda: ddist(k=8, rho=0.8),
    "isgd": isgd,
}


def resnet_zoo(n_classes: int) -> dict:
    """The paper's exact heterogeneous families (Table I) at the
    reference walkthrough's reduced width 8."""
    zoo = {}
    for cfg in (RESNET8, RESNET20, RESNET50):
        cfg = dataclasses.replace(cfg, n_classes=n_classes, width=8)
        zoo[cfg.name] = resnet1d_family(cfg)
    return zoo


def run(*, device: Device = None, rounds: int = 40, protocol: str = "sqmd",
        resnet: bool = False, ckpt: str = "runs/federation_ckpt",
        init_params: Optional[Mapping] = None, batch_indices=None,
        callbacks: Sequence = ()) -> dict:
    """The federation on ``device`` (None: the card), saved to
    ``ckpt/step_<rounds>.msgpack``. ``init_params``, ``batch_indices``
    and ``callbacks`` (run after the walkthrough's own) go to
    ``FederationEngine.build``. Returns the printed numbers, the
    checkpoint's path, the History and the engine."""
    ds = sc_like(samples_per_client=60, ref_size=120)
    splits = make_splits(ds, seed=0, label_noise=0.3)
    zoo = (resnet_zoo(ds.n_classes) if resnet
           else hetero_mlp_zoo(ds.feature_len, ds.n_classes))
    fams = list(zoo)
    # Table I ratio: ~N/3 clients per architecture family
    assignment = [fams[i % len(fams)] for i in range(ds.n_clients)]

    proto = PROTOS[protocol]()
    print(f"protocol={proto.name} families={fams} "
          f"clients={ds.n_clients}")

    # per-eval metrics arrive through a round callback (no polling of the
    # history between rounds)
    t0 = time.time()

    def log(eng, rnd, m):
        print(f"  [cb] round {rnd:4d}  acc={m['acc']:.4f}  "
              f"val={m['val_acc']:.4f}  ({time.time()-t0:.0f}s)", flush=True)

    engine = FederationEngine.build(
        ds, splits, zoo, assignment, proto,
        config=FederationConfig(rounds=rounds, batch_size=16, eval_every=5),
        seed=1, callbacks=[log, *callbacks], device=device,
        init_params=init_params, batch_indices=batch_indices)
    hist = engine.fit(splits)
    prec, rec = precision_recall(engine.fed, splits, ds.n_classes)
    print(f"\n{proto.name}: acc={hist.mean_acc[-1]:.4f} "
          f"macro-pre={prec:.4f} macro-rec={rec:.4f} "
          f"({time.time()-t0:.0f}s)")

    os.makedirs(ckpt, exist_ok=True)
    save_federation(ckpt, engine.fed, step=rounds)
    path = os.path.join(ckpt, f"step_{rounds}.msgpack")
    print(f"checkpoint -> {ckpt}/step_{rounds}.msgpack")
    return {"acc": hist.mean_acc[-1], "precision": prec, "recall": rec,
            "families": fams, "checkpoint": path, "history": hist,
            "engine": engine}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--protocol", choices=tuple(PROTOS), default="sqmd")
    ap.add_argument("--resnet", action="store_true",
                    help="use the paper's ResNet-1D families (slower)")
    ap.add_argument("--ckpt", default="runs/federation_ckpt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    run(device=args.device, rounds=args.rounds, protocol=args.protocol,
        resnet=args.resnet, ckpt=args.ckpt)


if __name__ == "__main__":
    main()
