"""ResNet-1D on the port: ``repro_torch.models.resnet.resnet1d_family``
of a ``ResNet1DConfig``; leaves ``params.<path>`` are the reference's
``<path>``, convolutions (C_out, C_in, K) on both sides."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.families.common import export


def program_family(fam: dict, in_dim: int, n_classes: int):
    from repro_torch.models.resnet import ResNet1DConfig, resnet1d_family
    return resnet1d_family(ResNet1DConfig(
        fam["name"], tuple(fam["blocks"]), int(fam["width"]),
        bool(fam["bottleneck"]), n_classes))


def init_params(weights: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The stacked leaves as ``init_params=`` takes them: numpy, keyed by
    path, convolutions in the (n_c, K, C_in, C_out) order it turns back."""
    return {k: (v.permute(0, 3, 2, 1) if v.dim() == 4 else v)
            .contiguous().numpy() for k, v in weights.items()}


def _rename(name: str) -> str:
    return name[len("params."):] if name.startswith("params.") else name


def read(cohort) -> dict:
    return export(cohort, _rename)
