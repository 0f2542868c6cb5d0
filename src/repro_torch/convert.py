"""Carry a cohort's weights, and D-Dist's static graph, across from the
reference's layout.

Each function takes one cohort's stacked params as the reference keeps
them, with every leaf already turned into a numpy array, and returns the
port's tensors:

  * ``cohort_params_from_numpy``: an MLP tier's
    ``{"layers": [{"w": (n_c, in, out), "b": (n_c, out)}, ...]}`` -> the
    stacked ``(w, b)`` pairs ``CohortMLP.load_layers`` takes;
  * ``family_params_from_numpy``: any other family's pytree -> the flat
    ``{"a/b/c": tensor}`` dict ``StackedCohort.load_params`` takes, keyed
    by the pytree path. Layouts stay the reference's (attention's
    ``(d, h, hd)``, SSD's fused ``w_in``, RG-LRU's ``(nb, wb, wb)`` gates)
    except the ResNet's convolutions, whose HIO ``(n_c, K, C_in, C_out)``
    becomes ``(n_c, C_out, C_in, K)``.

``load_cohort_params`` picks the right one for a cohort module;
``FederationEngine.build(init_params=...)`` goes through it.
``cohort_params_to_numpy`` goes the other way: a cohort module's params
in the reference's layout, as numpy (list indices become string keys,
which flatten to the same paths). ``numpy_cohort_inputs`` makes, from
numpy seeds, the starting weights and batch draws that two runs of one
federation (the card's and the CPU's) share.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import Device, resolve_device
from repro_torch.models.common import StackedCohort
from repro_torch.models.mlp import CohortMLP


def cohort_params_from_numpy(stacked: Mapping
                             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    layers = stacked["layers"]
    return [(torch.from_numpy(np.array(layer["w"], np.float32)),
             torch.from_numpy(np.array(layer["b"], np.float32)))
            for layer in layers]


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def family_params_from_numpy(family: str, stacked: Mapping
                             ) -> Dict[str, torch.Tensor]:
    """A non-MLP family's stacked reference pytree -> the port's flat
    stacked tensors (``family`` is ``StackedCohort.family``)."""
    out = {}
    for key, leaf in _flatten(stacked).items():
        t = torch.from_numpy(np.array(leaf))
        if family == "resnet" and t.dim() == 4:      # conv: HIO -> OIH
            t = t.permute(0, 3, 2, 1).contiguous()
        out[key] = t
    return out


def load_cohort_params(model: nn.Module, stacked: Mapping) -> None:
    """Copy one cohort's stacked reference params into ``model``."""
    if isinstance(model, CohortMLP):
        model.load_layers(cohort_params_from_numpy(stacked))
    elif isinstance(model, StackedCohort):
        model.load_params(family_params_from_numpy(model.family, stacked))
    else:
        raise TypeError(f"no conversion for a {type(model).__name__}")


def cohort_params_to_numpy(model: nn.Module) -> Dict:
    """A cohort module's stacked params in the reference's layout, as a
    nested dict of numpy arrays: the inverse of ``load_cohort_params``."""
    if isinstance(model, CohortMLP):
        return {"layers": [{"w": w.detach().cpu().numpy(),
                            "b": b.detach().cpu().numpy()}
                           for w, b in zip(model.w, model.b)]}
    if not isinstance(model, StackedCohort):
        raise TypeError(f"no conversion for a {type(model).__name__}")
    out: Dict = {}
    for key, p in model.params.items():
        t = p.detach().cpu()
        if model.family == "resnet" and t.dim() == 4:  # conv: OIH -> HIO
            t = t.permute(0, 3, 2, 1)
        *path, leaf = key.split("/")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.contiguous().numpy()
    return out


def static_weights_from_numpy(weights: np.ndarray,
                              device: Device = None) -> torch.Tensor:
    """D-Dist's dense (N, N) static graph -> an fp32 tensor on ``device``
    (None: the card), for ``FederationEngine.build(static_weights=)``."""
    w = np.array(weights, np.float32)
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        raise ValueError(f"static weights must be (N, N), got {w.shape}")
    return torch.from_numpy(w).to(resolve_device(device))


def numpy_cohort_inputs(families: Mapping[str, Callable],
                        assignment: Sequence[str], splits: Sequence,
                        batch: int, seed: int
                        ) -> Tuple[Dict[str, Dict], Callable]:
    """Numpy-made ``init_params`` and ``batch_indices`` for a federation
    of ``families`` (cohort builders) under ``assignment``.

    Each family with clients gets stacked params in the reference's
    layout: weights N(0, 1/fan_in); vectors (norm scales, biases, decay
    rates) the family's own init plus N(0, 0.1), drawn from ``seed``.
    ``batch_indices(step, ci)`` draws (n_c, batch) indices below the
    cohort's smallest train split from ``(seed + 1, step, ci)``."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [fill(v) for v in tree]
        if tree.ndim >= 3:
            w = rng.normal(size=tree.shape) / np.sqrt(
                np.prod(tree.shape[1:-1]))
        else:
            w = tree + 0.1 * rng.normal(size=tree.shape)
        return w.astype(np.float32)

    init, sizes = {}, []
    for fam, build in families.items():
        ids = [i for i, f in enumerate(assignment) if f == fam]
        if ids:
            init[fam] = fill(cohort_params_to_numpy(
                build(len(ids), device=torch.device("cpu"))))
            sizes.append((len(ids), min(len(splits[i].train_y)
                                        for i in ids)))

    def draws(step: int, ci: int) -> np.ndarray:
        n_c, m = sizes[ci]
        return np.random.default_rng((seed + 1, step, ci)).integers(
            0, m, (n_c, batch))

    return init, draws
