"""Mesh construction for the launchers.

* ``make_client_mesh``: the federation's 1-D client mesh (no process
  group: shards never exchange anything).
* ``make_production_mesh`` / ``make_host_mesh``: the LM dry run's
  ``DeviceMesh``es, 16x16 ("data","model") per pod, 2x16x16 with a
  leading "pod" axis, and 1x1. Each needs a default process group of the
  mesh's size; ``fake_process_group`` starts one that communicates
  nothing (``torch.testing._internal.distributed.fake_pg``), so one
  process stands for rank 0 of 256 or 512 ranks and sees rank 0's shards.
  Meshes are built by functions, never at import, so importing this
  module touches no process group.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

from repro_torch import Device, resolve_device
from repro_torch.sharding import ClientMesh
from repro_torch.sharding import make_client_mesh as _make

POD_SHAPE = (16, 16)
POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def make_client_mesh(n_dev: Optional[int] = None,
                     device: Device = None) -> ClientMesh:
    """1-D client mesh for federation sharding: cohort stacks and the
    server's divergence rows split over it (``FederationConfig(devices=)``,
    ``federate --devices``)."""
    return _make(n_dev, device=device)


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A default process group of ``world_size`` ranks that communicates
    nothing, this process rank 0, destroyed on exit (and any group left
    behind by the body with it). Refuses to start over an existing
    group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(world_size))
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _device_mesh(shape, axes, device: Device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a default process "
            f"group of {n} ranks; start one with fake_process_group({n})")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: Device = None):
    """16x16 ("data","model") per pod; 2x16x16 with a leading "pod" axis
    for the 512-rank multi-pod dry run. ``device`` (None: the card) sets
    the mesh's device type."""
    if multi_pod:
        return _device_mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device)
    return _device_mesh(POD_SHAPE, POD_AXES, device)


def make_host_mesh(device: Device = None):
    """A 1x1 ("data","model") mesh (one rank): every spec replicates."""
    return _device_mesh((1, 1), POD_AXES, device)
