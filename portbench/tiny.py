"""A cell cut to a size the CPU tests can run in a second or two: its
configuration's shapes shrunk, its traffic, metrics and limits as they
stand. Only the tests use it; the benchmark runs cells at their size."""
from __future__ import annotations

import copy

from portbench import spec

TINY = {
    "resnet1d": {"n_clients": 6, "length": 16, "samples_per_client": 20,
                 "ref_size": 12, "q": 3, "k": 2, "batch_size": 4,
                 "warm_seconds": 0.0},
}


def tiny_cell(name: str, root=spec.ROOT, **sizes) -> spec.Cell:
    """The cell ``name`` at the tiny sizes of its first family's kind,
    with ``sizes`` overriding them."""
    cell = spec.load_cell(name, root)
    cfg = copy.deepcopy(cell.config)
    t = {**TINY[cfg["families"][0]["kind"]], **sizes}
    cfg["n_clients"] = t["n_clients"]
    cfg["batch_size"] = t["batch_size"]
    cfg["warm_seconds"] = t["warm_seconds"]
    cfg["task"].update(length=t["length"],
                       samples_per_client=t["samples_per_client"],
                       ref_size=t["ref_size"])
    cfg["protocol"].update(q=t["q"], k=t["k"])
    cell.config = cfg
    return cell
