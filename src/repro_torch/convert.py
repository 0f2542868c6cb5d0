"""Carry a cohort's weights across from the reference's layout.

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


def cohort_params_from_numpy(stacked: Mapping
                             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    layers = stacked["layers"]
    return [(torch.from_numpy(np.array(layer["w"], np.float32)),
             torch.from_numpy(np.array(layer["b"], np.float32)))
            for layer in layers]
