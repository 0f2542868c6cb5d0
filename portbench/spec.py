"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; the configuration's
``file`` is given in ``BENCHMARK.json``, the mix is
``portbench/traffic/<traffic>.json``, each per-layer metric is
``portbench/metrics/<metric>.py``, each model kind ``portbench/
families/<kind>.py`` (the port's side) and ``portbench/reference/
<kind>.py`` (the plain side), and each configuration's limits for the
output check ``portbench/limits/<config>.json``. Every path is taken
relative to the root of the checkout, so a later change adds a cell, a
mix, a metric or a kind by adding files and entries only.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "portbench"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # the configuration file's contents
    traffic: dict           # the mix's parameters
    chips: int
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports
    limits: dict            # the output check's rule and limits
    root: Path


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; "
                       f"there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = read_json(root / entry["file"])
    traffic = read_json(root / PACKAGE / "traffic" / f"{w['traffic']}.json")
    limits = read_json(root / PACKAGE / "limits" / f"{w['config']}.json")
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                limits=limits, root=root)


def _load_file(path: Path, qualname: str) -> ModuleType:
    """Import the module at ``path`` under ``qualname`` (once)."""
    if qualname in sys.modules:
        return sys.modules[qualname]
    if not path.exists():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(qualname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[qualname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[qualname]
        raise
    return mod


def _module(root: Path, folder: str, name: str) -> ModuleType:
    path = root / PACKAGE / folder / f"{name}.py"
    tag = "" if root == ROOT else f"_{abs(hash(str(root)))}"
    return _load_file(path, f"{PACKAGE}.{folder}.{name}{tag}")


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """``portbench/metrics/<name>.py``: a module with ``read(ctx)``."""
    return _module(root, "metrics", name)


def family_adapter(kind: str, root: Path = ROOT) -> ModuleType:
    """``portbench/families/<kind>.py``: the port's side of a kind."""
    return _module(root, "families", kind)


def reference_kind(kind: str, root: Path = ROOT) -> ModuleType:
    """``portbench/reference/<kind>.py``: the plain side of a kind."""
    return _module(root, "reference", kind)


def metric_readers(cell: Cell) -> Dict[str, ModuleType]:
    return {m["name"]: metric_reader(m["name"], cell.root)
            for m in cell.per_layer}
