"""Small heterogeneous MLP client families as stacked cohort modules.

A cohort of ``n_c`` clients sharing one architecture is one module whose
params keep the reference's stacked layout: layer i has ``w`` of shape
``(n_c, in, out)`` and ``b`` of shape ``(n_c, out)``. The forward pass is
one ``torch.bmm`` per layer over the client axis; clients never interact,
so one backward of the summed per-client losses gives each client its own
gradient.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    name: str
    in_dim: int
    hidden: Tuple[int, ...]
    n_classes: int

    @property
    def dims(self) -> Tuple[int, ...]:
        return (self.in_dim, *self.hidden, self.n_classes)


class CohortMLP(nn.Module):
    """``n_clients`` independent MLPs of one config, stacked."""

    def __init__(self, cfg: MLPConfig, n_clients: int, *,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.n_clients = n_clients
        dims = cfg.dims
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for a, b in zip(dims[:-1], dims[1:]):
            w = torch.randn((n_clients, a, b), generator=generator,
                            dtype=torch.float32, device=device)
            self.w.append(nn.Parameter(w / math.sqrt(a)))
            self.b.append(nn.Parameter(
                torch.zeros((n_clients, b), dtype=torch.float32,
                            device=device)))

    @torch.no_grad()
    def load_layers(self, layers: Sequence[Tuple[torch.Tensor,
                                                 torch.Tensor]]) -> None:
        """Copy stacked (w, b) pairs in (e.g. from ``repro_torch.convert``)."""
        if len(layers) != len(self.w):
            raise ValueError(f"{self.cfg.name}: {len(layers)} layers given, "
                             f"the module has {len(self.w)}")
        for (w, b), pw, pb in zip(layers, self.w, self.b):
            if tuple(w.shape) != tuple(pw.shape) or \
                    tuple(b.shape) != tuple(pb.shape):
                raise ValueError(
                    f"{self.cfg.name}: layer shapes {tuple(w.shape)}, "
                    f"{tuple(b.shape)} do not match {tuple(pw.shape)}, "
                    f"{tuple(pb.shape)}")
            pw.copy_(w)
            pb.copy_(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (n_c, B, ...) per-client inputs -> logits (n_c, B, C)."""
        h = x.reshape(x.shape[0], x.shape[1], -1)
        last = len(self.w) - 1
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            h = torch.bmm(h, w) + b[:, None, :]
            if i < last:
                h = torch.relu(h)
        return h


def mlp_family(cfg: MLPConfig):
    """The tier's cohort builder, ``(n_clients, *, device, generator) ->
    CohortMLP``."""
    def build(n_clients: int, *, device, generator=None) -> CohortMLP:
        return CohortMLP(cfg, n_clients, device=device, generator=generator)
    return build


def hetero_mlp_zoo(in_dim: int, n_classes: int) -> Dict[str, MLPConfig]:
    """Three capacity tiers mirroring the paper's ResNet8/20/50 split, as
    configs (the engines build a ``CohortMLP`` for each)."""
    return {
        "mlp-s": MLPConfig("mlp-s", in_dim, (32,), n_classes),
        "mlp-m": MLPConfig("mlp-m", in_dim, (64, 64), n_classes),
        "mlp-l": MLPConfig("mlp-l", in_dim, (128, 128, 64), n_classes),
    }
