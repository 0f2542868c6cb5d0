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
in the reference's layout, as numpy, lists where the reference's pytree
has lists. ``opt_state_to_numpy`` and ``opt_state_from_numpy`` carry an
optimizer state both ways: the port's lists aligned with
``model.parameters()`` against the reference's pytrees shaped like the
params, the per-client step counter as it is. ``numpy_cohort_inputs``
makes, from numpy seeds, the starting weights and batch draws that two
runs of one federation (the card's and the CPU's) share.

The LM zoo's trees (``repro_torch.models.transformer``) keep the
reference's layout, so ``lm_tree_from_numpy``/``lm_tree_to_numpy``
carry a param tree or a decode cache leaf for leaf. A bf16 leaf crosses
as its bits: numpy has no bfloat16, and ``np.asarray`` of a JAX bf16
array has the ``bfloat16`` dtype of ``ml_dtypes``, which the port does
not import. It is recognised by its name and read through a ``uint16``
view; the way back writes ``uint16`` arrays, which the reference's side
views as bf16. ``lm_opt_state_to_numpy``/``lm_opt_state_from_numpy``
carry a ``single_model`` optimizer state (the 0-d step, moment trees)
the same way.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, Mapping, NamedTuple,
                    Sequence, Tuple)

import numpy as np
import torch
from torch import nn

from repro_torch import Device, resolve_device
from repro_torch.models.common import StackedCohort, tree_map
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


def _reference_paths(model: nn.Module) -> List[str]:
    """Each parameter's path in the reference's pytree ("layers/0/w",
    "stages/1/0/w1"), in ``model.parameters()`` order."""
    if isinstance(model, CohortMLP):
        return [f"layers/{name.split('.')[1]}/{name.split('.')[0]}"
                for name, _ in model.named_parameters()]
    if isinstance(model, StackedCohort):
        return [name[len("params."):] for name, _ in model.named_parameters()]
    raise TypeError(f"no conversion for a {type(model).__name__}")


def _listify(node):
    """Nested dicts whose keys are 0..n-1 (strings of digits) -> lists."""
    if not isinstance(node, dict):
        return node
    keys = list(node)
    if keys and all(k.isdigit() for k in keys) and \
            sorted(map(int, keys)) == list(range(len(keys))):
        return [_listify(node[str(i)]) for i in range(len(keys))]
    return {k: _listify(v) for k, v in node.items()}


def tensors_to_numpy(model: nn.Module,
                     tensors: Sequence[torch.Tensor]) -> Dict:
    """Tensors aligned with ``model.parameters()`` (the params, or one
    optimizer moment) -> the reference's pytree of numpy arrays."""
    resnet = getattr(model, "family", None) == "resnet"
    out: Dict = {}
    for path, t in zip(_reference_paths(model), tensors, strict=True):
        t = t.detach().cpu()
        if resnet and t.dim() == 4:                  # conv: OIH -> HIO
            t = t.permute(0, 3, 2, 1)
        *parents, leaf = path.split("/")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t.contiguous().numpy()
    return _listify(out)


def tensors_from_numpy(model: nn.Module, tree,
                       like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The reference's pytree (params, or one optimizer moment) -> tensors
    aligned with ``model.parameters()``, each of the shape, dtype and
    device of its counterpart in ``like``; raises on a missing, extra or
    misshapen leaf before anything is returned."""
    if isinstance(model, CohortMLP):
        pairs = cohort_params_from_numpy(tree)
        named = {f"{k}.{i}": t for i, pair in enumerate(pairs)
                 for k, t in zip("wb", pair)}
    elif isinstance(model, StackedCohort):
        named = {f"params.{k}": t for k, t in
                 family_params_from_numpy(model.family, tree).items()}
    else:
        raise TypeError(f"no conversion for a {type(model).__name__}")
    names = [name for name, _ in model.named_parameters()]
    if set(named) != set(names):
        raise ValueError(f"leaves {sorted(set(named) ^ set(names))} are in "
                         f"only one of the file and the module")
    out = []
    for name, ref in zip(names, like):
        t = named[name]
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the "
                             f"module {tuple(ref.shape)}")
        out.append(t.to(device=ref.device, dtype=ref.dtype))
    return out


def cohort_params_to_numpy(model: nn.Module) -> Dict:
    """A cohort module's stacked params in the reference's layout, as a
    nested tree of numpy arrays: the inverse of ``load_cohort_params``."""
    return tensors_to_numpy(model, list(model.parameters()))


def opt_state_to_numpy(model: nn.Module, state: NamedTuple) -> Dict[str, Any]:
    """An optimizer state (``SGDState``/``AdamState``) as the reference's
    fields: the ``(n_c,)`` step counter as numpy, each per-parameter list
    (momentum, mu, nu) as a pytree shaped like the params, None kept."""
    out: Dict[str, Any] = {}
    for name, value in state._asdict().items():
        if isinstance(value, torch.Tensor):
            out[name] = value.detach().cpu().numpy()
        elif value is None:
            out[name] = None
        else:
            out[name] = tensors_to_numpy(model, value)
    return out


def opt_state_from_numpy(model: nn.Module, fields: Mapping[str, Any],
                         template: NamedTuple) -> NamedTuple:
    """The reference's optimizer-state fields -> a state of ``template``'s
    type, each tensor of the shape, dtype and device of the template's."""
    names = set(template._fields)
    if set(fields) != names:
        raise ValueError(f"optimizer state fields {sorted(fields)} do not "
                         f"match {type(template).__name__}'s {sorted(names)}")
    out = {}
    for name, like in template._asdict().items():
        value = fields[name]
        if isinstance(like, torch.Tensor):
            t = torch.from_numpy(np.array(value))
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"{name} has shape {tuple(t.shape)}, the "
                                 f"state {tuple(like.shape)}")
            out[name] = t.to(device=like.device, dtype=like.dtype)
        elif like is None or value is None:
            if (like is None) != (value is None):
                raise ValueError(f"{name} is None in only one of the file "
                                 f"and the state")
            out[name] = None
        else:
            out[name] = tensors_from_numpy(model, value, like)
    return type(template)(**out)


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


def _leaf_from_numpy(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a bf16 leaf of restore_pytree
        return a.to(device, copy=True)
    a = np.array(a)                  # an own, writable, C-ordered copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def lm_tree_from_numpy(tree, device: Device = None):
    """The reference's LM param tree (``init_params``) or decode cache
    (``prefill``, ``init_cache``; ``{"groups": {"pos{i}": ...}, "rem":
    [...]}``), leaves as numpy, -> the port's tree of tensors on
    ``device`` (None: the card), dtypes kept (int32 ``k_pos``/``pos``
    too), bf16 bit for bit. A leaf may also be a tensor already, as
    ``restore_pytree`` returns a bf16 one: it is copied to ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(a, dev), tree)


def lm_tree_to_numpy(tree):
    """The port's LM params or decode cache -> the reference's tree of
    numpy arrays (bf16 leaves as ``uint16`` bits)."""
    return tree_map(_leaf_to_numpy, tree)


def lm_opt_state_to_numpy(state: NamedTuple) -> Dict[str, Any]:
    """A ``single_model`` optimizer state (``AdamState``/``SGDState``:
    the 0-d step, moments as trees shaped like the params) -> the
    reference's fields as numpy, None kept."""
    return {name: None if value is None else lm_tree_to_numpy(value)
            for name, value in state._asdict().items()}


def lm_opt_state_from_numpy(fields: Mapping[str, Any], state_type,
                            device: Device = None) -> NamedTuple:
    """The reference's LM optimizer state (its fields as numpy: the 0-d
    int32 step, ``mu``/``nu`` or ``momentum`` trees) -> a ``state_type``
    (``AdamState``, ``SGDState``) for ``single_model``, on ``device``
    (None: the card)."""
    if set(fields) != set(state_type._fields):
        raise ValueError(f"optimizer state fields {sorted(fields)} do not "
                         f"match {state_type.__name__}'s "
                         f"{sorted(state_type._fields)}")
    return state_type(**{
        name: None if fields[name] is None
        else lm_tree_from_numpy(fields[name], device)
        for name in state_type._fields})
