"""Quickstart: the SQMD protocol with the port's public API.

Builds a 28-client heterogeneous federation (3 MLP families) on a
synthetic apnea-like dataset, trains 25 rounds with the SQMD policy
through the ``FederationEngine``, and prints the accuracy plus the REAL
collaboration graph the server last built.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch import Device
from repro_torch.core import (FederationConfig, FederationEngine,
                              graph_stats, sqmd)
from repro_torch.data import make_splits, pad_like
from repro_torch.models import hetero_mlp_zoo


def cluster_agreement(weights: np.ndarray,
                      cluster: np.ndarray) -> Tuple[float, float]:
    """How well similarity recovered the ground-truth clusters: per
    client, the share of its neighbors (the nonzero entries of its row of
    W) in its own cluster, averaged; and what a random pick would give."""
    hit = [np.mean(cluster[np.where(weights[i] > 0)[0]] == cluster[i])
           for i in range(len(cluster))]
    rand = np.mean([np.mean(cluster == c) for c in cluster])
    return float(np.mean(hit)), float(rand)


def report(final_acc: float, stats: Mapping,
           agreement: Tuple[float, float]) -> List[str]:
    """The walkthrough's closing lines."""
    hit, rand = agreement
    return [f"\nfinal mean test accuracy: {final_acc:.4f}",
            f"collaboration graph: {dict(stats)}",
            f"neighbor/cluster agreement: {hit:.2f} "
            f"(random would be ~{rand:.2f})"]


def run(*, device: Device = None, samples_per_client: int = 60,
        ref_size: int = 120, rounds: int = 25,
        init_params: Optional[Mapping] = None, batch_indices=None,
        callbacks: Sequence = ()) -> dict:
    """The walkthrough on ``device`` (None: the card). ``init_params``,
    ``batch_indices`` and ``callbacks`` go to ``FederationEngine.build``
    (the seams through which a twin run shares its weights and draws).
    Returns the printed numbers, the History and the engine."""
    # 1. data: 28 clients with private non-IID shards + a shared reference
    #    set whose labels only the server holds (paper Def. 1)
    ds = pad_like(samples_per_client=samples_per_client, ref_size=ref_size)
    splits = make_splits(ds, seed=0, label_noise=0.3)

    # 2. heterogeneous client models: three capacity tiers, mirroring the
    #    paper's ResNet8/20/50 mix — no parameter averaging is possible
    zoo = hetero_mlp_zoo(ds.feature_len, ds.n_classes)
    assignment = [list(zoo)[i % 3] for i in range(ds.n_clients)]

    # 3. the policy: quality top-Q filter, similarity top-K neighbors,
    #    distill with weight rho (paper Eq. 6)
    engine = FederationEngine.build(
        ds, splits, zoo, assignment, sqmd(q=12, k=6, rho=0.8),
        config=FederationConfig(rounds=rounds, batch_size=16, eval_every=5,
                                verbose=True),
        seed=1, callbacks=callbacks, device=device, init_params=init_params,
        batch_indices=batch_indices)
    hist = engine.fit(splits)

    # 4. the graph the policy last built, and the clusters it recovered
    stats = graph_stats(engine.last_graph)
    hit, rand = cluster_agreement(engine.server.weights.cpu().numpy(),
                                  ds.client_cluster)
    print("\n".join(report(hist.mean_acc[-1], stats, (hit, rand))))
    return {"final_acc": hist.mean_acc[-1], "graph_stats": stats,
            "cluster_agreement": hit, "random_agreement": rand,
            "history": hist, "engine": engine}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
