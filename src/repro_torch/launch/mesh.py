"""Mesh construction for the launchers: the client mesh only. The
reference's production and host meshes serve its LM dry run, which the
port has not taken yet."""
from __future__ import annotations

from typing import Optional

from repro_torch import Device
from repro_torch.sharding import ClientMesh
from repro_torch.sharding import make_client_mesh as _make


def make_client_mesh(n_dev: Optional[int] = None,
                     device: Device = None) -> ClientMesh:
    """1-D client mesh for federation sharding: cohort stacks and the
    server's divergence rows split over it (``FederationConfig(devices=)``,
    ``federate --devices``)."""
    return _make(n_dev, device=device)
