"""Carry a cohort's weights, and D-Dist's static graph, across from the
reference's layout.

``cohort_params_from_numpy`` takes one cohort's stacked params as the
reference keeps them, with every leaf already turned into a numpy array
(``{"layers": [{"w": (n_c, in, out), "b": (n_c, out)}, ...]}``), and
returns the port's stacked ``(w, b)`` pairs, ready for
``CohortMLP.load_layers`` or ``FederationEngine.build(init_params=...)``.
"""
from __future__ import annotations

from typing import List, Mapping, Tuple

import numpy as np
import torch

from repro_torch import Device, resolve_device


def cohort_params_from_numpy(stacked: Mapping
                             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    layers = stacked["layers"]
    return [(torch.from_numpy(np.array(layer["w"], np.float32)),
             torch.from_numpy(np.array(layer["b"], np.float32)))
            for layer in layers]


def static_weights_from_numpy(weights: np.ndarray,
                              device: Device = None) -> torch.Tensor:
    """D-Dist's dense (N, N) static graph -> an fp32 tensor on ``device``
    (None: the card), for ``FederationEngine.build(static_weights=)``."""
    w = np.array(weights, np.float32)
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        raise ValueError(f"static weights must be (N, N), got {w.shape}")
    return torch.from_numpy(w).to(resolve_device(device))
