"""Client-axis sharding of the federation.

The federation's unit of parallelism is the CLIENT: a cohort is a stacked
(n_c, ...) module whose rows never interact, so a local round splits
into independent blocks of rows. A ``ClientMesh`` is a tuple of devices;
each cohort is ghost-padded to a multiple of its size and split into one
``CohortShard`` a device, each with its own stacked module, optimizer
state and data. Ghost rows copy the last real client (never zeros, so
every forward stays finite on them) and stay outside the trainable mask,
which makes them exact no-ops. The server's O(N²·R·C) divergence rebuild
splits into row strips over the same devices
(``core.similarity.divergence_matrix(mesh=)``).

No process group is involved: rows never exchange anything, so placement
is explicit. On the CPU a mesh is ``n_dev`` entries of ``cpu``, the
counterpart of the reference's fake host devices; on the card it is the
first ``n_dev`` visible cards. A mesh may also repeat one device (the
engines' ``mesh=`` seam), which runs every shard on the one card.

The reference's LM-zoo GSPMD rules (``param_specs``, ``batch_specs``,
``cache_specs``, ``opt_specs``, ``ShardingPolicy``,
``make_fsdp_gather_hook``) are not here: their only consumer is the
reference's dry run, which the port has not taken yet.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch import Device, resolve_device

CLIENT_AXIS = "clients"


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """A 1-D mesh over the client axis: one device an entry (entries may
    repeat a device)."""
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a client mesh needs at least one device")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a client mesh cannot mix device types: "
                             f"{self.devices}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {CLIENT_AXIS: self.size}


def make_client_mesh(n_dev: Optional[int] = None,
                     device: Device = None) -> ClientMesh:
    """A mesh over the first ``n_dev`` cards (default: every visible one),
    or, with ``device="cpu"``, ``n_dev`` entries of the CPU (default 1).
    ``device=None`` is the card, and raises without one."""
    if n_dev is not None and int(n_dev) < 1:
        raise ValueError(f"n_dev must be >= 1, got {n_dev}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        return ClientMesh((dev,) * (1 if n_dev is None else int(n_dev)))
    visible = torch.cuda.device_count()
    n_dev = visible if n_dev is None else int(n_dev)
    if n_dev > visible:
        raise ValueError(f"requested {n_dev} devices but only {visible} "
                         f"are visible")
    return ClientMesh(tuple(torch.device("cuda", i) for i in range(n_dev)))


def cohort_mesh(mesh: ClientMesh, n_clients: int) -> ClientMesh:
    """The mesh one cohort lives on: the whole mesh when it has at least
    as many clients as entries, else its first ``n_clients`` entries (a
    2-client cohort on an 8-entry mesh is 2 real rows on 2 devices, not 2
    real and 6 ghost rows)."""
    if n_clients >= mesh.size:
        return mesh
    return ClientMesh(mesh.devices[:max(1, int(n_clients))])


def ghost_rows(n: int, n_dev: int) -> int:
    """Ghost rows needed to pad ``n`` clients to a multiple of ``n_dev``."""
    return (-n) % n_dev


def map_tensors(fn, tree):
    """``fn`` applied to every tensor of a tree of NamedTuples, tuples,
    lists and dicts (None and other leaves kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return tree


def ghost_pad_stack(tree, pad: int):
    """Append ``pad`` ghost rows to every tensor's leading axis by
    repeating its last row (never zeros). A 0-d tensor is kept."""
    if pad == 0:
        return tree

    def one(a: torch.Tensor) -> torch.Tensor:
        if a.dim() == 0:
            return a
        return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))])

    return map_tensors(one, tree)


def device_scope(dev: torch.device):
    """Make ``dev`` the current card while the server's kernels launch on
    it (a no-op off the card)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


@dataclasses.dataclass
class CohortShard:
    """One device's block of a cohort's stacked rows: rows
    ``start .. start + n_rows`` of the ghost-padded stack."""
    model: nn.Module                     # stacked (n_rows, ...) params
    opt_state: Any                       # stacked, per-row step
    data: Dict[str, torch.Tensor]        # {x (n_rows,M,L), y (n_rows,M)}
    start: int = 0

    @property
    def device(self) -> torch.device:
        return self.data["y"].device

    @property
    def n_rows(self) -> int:
        return int(self.data["y"].shape[0])


def _rows(tree, lo: int, hi: int, dev: torch.device):
    """Rows ``lo:hi`` of every stacked tensor, copied onto ``dev``."""
    return map_tensors(lambda a: a if a.dim() == 0
                       else a[lo:hi].to(dev, copy=True), tree)


def module_with(model: nn.Module,
                params: Sequence[torch.Tensor]) -> nn.Module:
    """A copy of the stacked ``model`` whose parameters are ``params``
    (aligned with ``model.parameters()``), so a shard module is cut from
    the cohort's own weights and never drawn anew."""
    old = list(model.parameters())
    if len(old) != len(params):
        raise ValueError(f"{len(params)} tensors for {len(old)} params")
    memo = {id(p): nn.Parameter(t, requires_grad=p.requires_grad)
            for p, t in zip(old, params)}
    out = copy.deepcopy(model, memo)
    if hasattr(out, "n_clients"):
        out.n_clients = int(params[0].shape[0])
    return out


def place_cohort_stacks(cohort, mesh: ClientMesh) -> None:
    """Ghost-pad a one-shard cohort's params, optimizer state and data to
    a multiple of ``mesh.size`` rows and split them into one shard a mesh
    entry, in place. Records ``n_pad`` and ``mesh`` on the cohort."""
    if cohort.mesh is not None or len(cohort.shards) != 1:
        raise ValueError(f"cohort {cohort.family_name!r} is already "
                         f"sharded")
    whole = cohort.shards[0]
    pad = ghost_rows(cohort.n_clients, mesh.size)
    params = ghost_pad_stack([p.detach() for p in whole.model.parameters()],
                             pad)
    state = ghost_pad_stack(whole.opt_state, pad)
    data = ghost_pad_stack(whole.data, pad)
    rows = (cohort.n_clients + pad) // mesh.size
    shards = []
    for i, dev in enumerate(mesh.devices):
        lo, hi = i * rows, (i + 1) * rows
        shards.append(CohortShard(
            module_with(whole.model, _rows(params, lo, hi, dev)),
            _rows(state, lo, hi, dev), _rows(data, lo, hi, dev), lo))
    cohort.shards = shards
    cohort.n_pad = pad
    cohort.mesh = mesh


def repad_cohort_arrays(cohort, params: Sequence[torch.Tensor],
                        opt_state) -> None:
    """Write real-row params (aligned with the module's parameters) and
    optimizer state into the cohort's shards, ghost-padded as the cohort
    is (a checkpoint restore's last step)."""
    params = ghost_pad_stack(list(params), cohort.n_pad)
    state = ghost_pad_stack(opt_state, cohort.n_pad)
    for sh in cohort.shards:
        lo, hi = sh.start, sh.start + sh.n_rows
        with torch.no_grad():
            for p, t in zip(sh.model.parameters(), params):
                p.copy_(t[lo:hi])
        sh.opt_state = _rows(state, lo, hi, sh.device)
