"""The system under test: ``repro_torch``'s ``FederationEngine``, built
once from the benchmark's inputs, and what its rounds leave behind.

The engine gets the benchmark's data (numpy, as ``build`` takes it),
weights (the ``init_params`` seam, in the layout it takes), batch draws
(the ``batch_indices`` seam) and availability (a ``Schedule`` wrapping
``availability.mask``). Everything
is read back through the engine's public state: the cohorts' parameters
and optimizer state, ``fed.server`` (repository, grades, divergence),
``last_graph`` (pool, neighbours, slot weights) and ``fed.targets``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import spec
from portbench.families.common import host
from portbench.inputs import Inputs


def _schedule(inputs: Inputs):
    from repro_torch.core import Schedule

    class BenchmarkSchedule(Schedule):
        """The traffic mix's draw, handed to the engine."""
        name = "portbench"

        def available(self, rnd: int, n_clients: int) -> np.ndarray:
            return inputs.available(rnd)

    return BenchmarkSchedule()


def build(inputs: Inputs, device, root=spec.ROOT):
    """The engine of the configuration, with the benchmark's weights."""
    from repro_torch.core import FederationConfig, FederationEngine, sqmd
    from repro_torch.data import ClientSplit, FederatedDataset
    from repro_torch.optim import sgd
    cfg = inputs.config
    n, length = inputs.n_clients, inputs.in_dim
    empty_x = np.zeros((0, length), np.float32)
    empty_y = np.zeros((0,), np.int64)
    splits = [ClientSplit(inputs.x[i], inputs.y[i], empty_x, empty_y,
                          empty_x, empty_y) for i in range(n)]
    ds = FederatedDataset(cfg["name"], inputs.n_classes, length,
                          [inputs.x[i] for i in range(n)],
                          [inputs.y[i] for i in range(n)], inputs.ref_x,
                          inputs.ref_y.astype(np.int32), inputs.cluster)
    adapters = {f["name"]: spec.family_adapter(f["kind"], root)
                for f in cfg["families"]}
    families = {f["name"]: adapters[f["name"]].program_family(
        f, length, inputs.n_classes) for f in cfg["families"]}
    pro, opt = cfg["protocol"], cfg["optimizer"]
    if pro["policy"] != "sqmd" or opt["kind"] != "sgd":
        raise ValueError("the harness drives sqmd under SGD")
    engine = FederationEngine.build(
        ds, splits, families, inputs.assignment,
        sqmd(q=pro["q"], k=pro["k"], rho=pro["rho"],
             interval=pro["interval"]),
        config=FederationConfig(
            rounds=1, batch_size=cfg["batch_size"],
            local_steps=cfg["local_steps"], eval_every=1,
            delta_graph=cfg["delta_graph"], selection=cfg["selection"],
            uplink=cfg["uplink"], downlink=cfg["downlink"]),
        schedule=_schedule(inputs), seed=inputs.seed % (2 ** 63),
        device=device, batch_indices=inputs.draws,
        init_params={name: adapters[name].init_params(leaves)
                     for name, leaves in inputs.weights.items()},
        optimizer=sgd(opt["lr"], momentum=opt["momentum"]))
    return engine


def read_round(engine) -> Dict[str, torch.Tensor]:
    """What a fired round produced, copied to the host."""
    srv, g = engine.fed.server, engine.last_graph
    return {k: host(v) for k, v in (
        ("repo", srv.repo_logp), ("grades", srv.quality),
        ("div", srv.div_cache), ("active", srv.active),
        ("cand", g.candidates), ("nbrs", g.neighbors.long()),
        ("slot", g.slot_weights), ("targets", engine.fed.targets))}


def read_clients(engine, config: dict, root=spec.ROOT) -> Dict[str, dict]:
    """{family: {"params": {leaf: t}, "momentum": {leaf: t}}} on the host."""
    kinds = {f["name"]: f["kind"] for f in config["families"]}
    return {coh.family_name: spec.family_adapter(
        kinds[coh.family_name], root).read(coh)
        for coh in engine.fed.cohorts}
