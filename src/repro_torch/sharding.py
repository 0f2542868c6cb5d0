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

The LM zoo's GSPMD rules (``param_specs``, ``batch_specs``,
``cache_specs``, ``opt_specs``, ``ShardingPolicy``,
``make_fsdp_gather_hook``) follow, under the reference's names; the LM
dry run (``launch/dryrun.py``) is their consumer. A spec is the port's
own ``P``: a tuple with one entry a tensor dimension, each an axis name,
a tuple of names or ``None``; ``to_placements`` turns it into DTensor
``Shard``/``Replicate`` placements over a ``DeviceMesh``'s dimensions.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch import Device, resolve_device
from repro_torch.step_graph import StepGraphs
from repro_torch.tree import tree_map, tree_map_with_path

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
    ``start .. start + n_rows`` of the ghost-padded stack. On the card
    its steps are captured and replayed as CUDA graphs (``graphs``)."""
    model: nn.Module                     # stacked (n_rows, ...) params
    opt_state: Any                       # stacked, per-row step
    data: Dict[str, torch.Tensor]        # {x (n_rows,M,L), y (n_rows,M)}
    start: int = 0
    graphs: StepGraphs = dataclasses.field(
        default_factory=StepGraphs, init=False, repr=False, compare=False)

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


# ---------------------------------------------------------------------------
# the LM zoo's GSPMD rules (the dry run's layouts)
# ---------------------------------------------------------------------------
# Mesh axes: ("data", "model") single-pod 16x16, ("pod", "data", "model")
# multi-pod 2x16x16 (``launch/mesh.py``). The rules, the reference's:
#
#   batch dims            -> ("pod","data")
#   attention heads       -> "model" when n_heads  % axis == 0
#   kv heads (GQA)        -> "model" when n_kv     % axis == 0
#   d_ff / lru / d_inner  -> "model" (Megatron column/row parallel)
#   vocab (embed/lm_head) -> "model" when divisible
#   MoE experts           -> "model" when n_experts % axis == 0, else
#                            tensor-parallel inside each expert
#   long_500k KV caches   -> the sequence dim over "data"
#
# Every rule replicates a dimension the axis does not divide. A mesh is
# read through ``mesh_dim_names`` and ``shape`` (a ``DeviceMesh``'s, or
# any object that has them).

class P(tuple):
    """A partition spec: one entry a tensor dimension (leading ones; a
    missing trailing entry is replicated), each an axis name, a tuple of
    names sharded in that order, or ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Beyond-baseline strategies.

    dp_over_model: pure data parallelism; the batch shards over every
        mesh axis and every param replicates (small archs whose head
        counts the model axis does not divide).
    fsdp: ZeRO-3; the MoE/FFN weights and the optimizer moments also
        shard over "data" on their largest divisible dim, and each layer
        group gathers its weights back at use (``make_fsdp_gather_hook``).
    """
    dp_over_model: bool = False
    fsdp: bool = False


BASELINE = ShardingPolicy()


def _mesh_axes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def batch_axes(mesh, policy: ShardingPolicy = BASELINE) -> Tuple[str, ...]:
    names = tuple(mesh.mesh_dim_names)
    if policy.dp_over_model:
        return names
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_size(mesh, name: str) -> int:
    return _mesh_axes(mesh)[name]


def _div(dim: int, mesh, axis: str = "model") -> bool:
    return dim > 0 and dim % _axis_size(mesh, axis) == 0


def _layer_param_spec(path: str, leaf, cfg, mesh) -> P:
    """Spec of one per-layer leaf, ``path`` like 'mixer/wq' (no group
    dim)."""
    m = "model"
    shp = leaf.shape
    name = path.split("/")[-1]

    # attention (GQA)
    if name == "wq":
        if len(shp) == 3:                                    # (D, H, hd)
            return P(None, m, None) if _div(cfg.n_heads, mesh) else P()
        return P(None, m) if _div(shp[-1], mesh) else P()
    if name in ("wk", "wv"):
        return P(None, m, None) if _div(cfg.n_kv_heads, mesh) else P()
    if name == "wo":
        return P(m, None, None) if _div(shp[0], mesh) else P()
    if name == "bq":
        return P(m, None) if _div(cfg.n_heads, mesh) else P()
    if name in ("bk", "bv"):
        return P(m, None) if _div(cfg.n_kv_heads, mesh) else P()

    # MLA
    if name == "w_dkv":
        return P(None, m) if _div(shp[1], mesh) else P()
    if name in ("w_uk", "w_uv", "w_uq"):
        return P(None, m, None) if _div(shp[1], mesh) else P()
    if name == "w_dq":
        return P(None, m) if _div(shp[1], mesh) else P()

    # MoE and the dense FFN (shared experts take the dense branches)
    if name == "router":
        return P()
    if path.endswith("ffn/w_gate") or path.endswith("ffn/w_up"):
        if len(shp) == 3:                                    # (E, D, F)
            if _div(cfg.n_experts, mesh):
                return P(m, None, None)
            return P(None, None, m) if _div(shp[2], mesh) else P()
        return P(None, m) if _div(shp[1], mesh) else P()     # (D, F)
    if path.endswith("ffn/w_down"):
        if len(shp) == 3:                                    # (E, F, D)
            if _div(cfg.n_experts, mesh):
                return P(m, None, None)
            return P(None, m, None) if _div(shp[1], mesh) else P()
        return P(m, None) if _div(shp[0], mesh) else P()     # (F, D)

    # SSD (mamba2)
    if name == "w_in":
        return P(None, m) if _div(shp[1], mesh) else P()
    if name == "w_out" and len(shp) == 2:
        return P(m, None) if _div(shp[0], mesh) else P()

    # RG-LRU: block-diagonal gates shard their block dim
    if name in ("w_y", "w_x"):
        return P(None, m) if _div(shp[1], mesh) else P()
    if name in ("w_a", "w_i"):
        return P(m, None, None) if _div(shp[0], mesh) else P()

    # norms, biases, conv filters, scalars
    return P()


def _top_param_spec(path: str, leaf, cfg, mesh) -> P:
    name = path.split("/")[-1]
    if name == "embed":
        return P("model", None) if _div(cfg.vocab_size, mesh) else P()
    if name == "lm_head":
        return P(None, "model") if _div(cfg.vocab_size, mesh) else P()
    return P()


def _path_str(path) -> str:
    """A key path (dict keys, list indices) as 'groups/pos0/mixer/wq'."""
    return "/".join(str(k) for k in path)


# FSDP applies only to these per-layer paths (the MoE expert weights, ~96 %
# of deepseek-v2's bytes), as in the reference.
_FSDP_PATHS = ("ffn/w_gate", "ffn/w_up", "ffn/w_down",
               "ffn/shared/w_gate", "ffn/shared/w_up", "ffn/shared/w_down")


def _fsdp_eligible(path: str) -> bool:
    return any(path.endswith(s) for s in _FSDP_PATHS)


def _add_fsdp(spec: P, shape, mesh, skip_lead: bool) -> P:
    """Shard the largest free, divisible dim over 'data' (ZeRO-3)."""
    dsz = _axis_size(mesh, "data")
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = -1, -1
    for i in range(1 if skip_lead else 0, len(shape)):
        if entries[i] is None and shape[i] % dsz == 0 and shape[i] > best_dim:
            best, best_dim = i, shape[i]
    if best >= 0 and best_dim >= 4 * dsz:    # skip tiny vectors
        entries[best] = "data"
    return P(*entries)


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def param_specs(params, cfg, mesh, policy: ShardingPolicy = BASELINE):
    """A spec tree matching a params tree (stacked groups get a leading
    None for the group dim)."""

    def spec(path, leaf):
        p = _path_str(path)
        if policy.dp_over_model:
            return P(*([None] * len(leaf.shape)))
        if p.startswith("groups/"):
            sub = p.split("/", 2)[2]              # strip groups/pos{i}/
            s = P(None, *_layer_param_spec(sub, _Shape(leaf.shape[1:]),
                                           cfg, mesh))
            if policy.fsdp and _fsdp_eligible(sub):
                s = _add_fsdp(s, leaf.shape, mesh, skip_lead=True)
            return s
        if p.startswith("rem/"):
            sub = p.split("/", 2)[2]
            s = _layer_param_spec(sub, leaf, cfg, mesh)
            if policy.fsdp and _fsdp_eligible(sub):
                s = _add_fsdp(s, leaf.shape, mesh, skip_lead=False)
            return s
        return _top_param_spec(p, leaf, cfg, mesh)

    return tree_map_with_path(spec, params)


def batch_specs(batch, mesh, policy: ShardingPolicy = BASELINE):
    """Every batch leaf's leading (batch) dim over ("pod","data") (every
    axis under dp_over_model) when it divides, else replicated."""
    ba = batch_axes(mesh, policy)
    total = 1
    for a in ba:
        total *= _axis_size(mesh, a)

    def spec(leaf):
        if leaf.shape[0] % total == 0:
            return P(ba, *([None] * (len(leaf.shape) - 1)))
        return P(*([None] * len(leaf.shape)))

    return tree_map(spec, batch)


def cache_specs(cache, cfg, mesh, shard_seq_threshold: int = 65536):
    """Decode-cache specs: the batch dim over ("pod","data") when it
    divides; a single long request (batch 1) shards the KV sequence dim
    over "data" instead (distributed flash-decode)."""
    ba = batch_axes(mesh)
    total = 1
    for a in ba:
        total *= _axis_size(mesh, a)
    dsz = _axis_size(mesh, "data")
    if len(ba) == 1:
        ba = ba[0]              # P("data", ...), not P(("data",), ...)

    def spec(path, leaf):
        p = _path_str(path)
        name = p.split("/")[-1]
        stacked = p.startswith("groups/")
        shp = tuple(leaf.shape[1:] if stacked else leaf.shape)
        if name in ("pos", "k_pos"):
            s = P(*([None] * len(shp)))
        elif name in ("k", "v"):                           # (B, S, KV, hd)
            if shp[0] % total == 0:
                s = P(ba, None, None, None)
            elif shp[1] % dsz == 0 and shp[1] >= shard_seq_threshold:
                s = P(None, "data", None, None)
            else:
                s = P(None, None, None, None)
        elif name in ("ckv", "krope"):                     # (B, S, r)
            if shp[0] % total == 0:
                s = P(ba, None, None)
            elif shp[1] % dsz == 0 and shp[1] >= shard_seq_threshold:
                s = P(None, "data", None)
            else:
                s = P(None, None, None)
        elif name == "state":
            if len(shp) == 4:                              # ssd (B,H,P,N)
                s = P(ba if shp[0] % total == 0 else None,
                      "model" if _div(shp[1], mesh) else None, None, None)
            else:                                          # rglru (B,W)
                s = P(ba if shp[0] % total == 0 else None,
                      "model" if _div(shp[1], mesh) else None)
        elif name == "conv":                               # (B, cw-1, C)
            s = P(ba if shp[0] % total == 0 else None, None,
                  "model" if _div(shp[2], mesh) else None)
        else:
            s = P(*([None] * len(shp)))
        return P(None, *s) if stacked else s

    return tree_map_with_path(spec, cache)


def opt_specs(opt_state, pspecs, mesh=None,
              policy: ShardingPolicy = BASELINE):
    """Adam/SGD moments share the param layout; the 0-d step replicates.
    Under FSDP a moment also shards over "data" wherever its param's spec
    left a divisible dim free (ZeRO-1: the update is elementwise)."""
    from repro_torch.optim import AdamState, SGDState
    mspecs = pspecs
    if policy.fsdp and mesh is not None and isinstance(opt_state, AdamState):
        def add(spec, leaf):
            flat = [a for e in spec if e is not None
                    for a in (e if isinstance(e, tuple) else (e,))]
            if "data" in flat:
                return spec
            return _add_fsdp(spec, leaf.shape, mesh,
                             skip_lead=len(spec) > 0 and spec[0] is None
                             and len(leaf.shape) > 3)
        def at(tree, path):
            for k in path:
                tree = tree[k]
            return tree
        mspecs = tree_map_with_path(
            lambda path, leaf: add(at(pspecs, path), leaf), opt_state.mu)
    if isinstance(opt_state, AdamState):
        return AdamState(step=P(), mu=mspecs, nu=mspecs)
    if isinstance(opt_state, SGDState):
        mom = None if opt_state.momentum is None else mspecs
        return SGDState(step=P(), momentum=mom)
    raise TypeError(f"unknown optimizer state {type(opt_state)}")


def spec_placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` over ``mesh``'s dimensions: a
    tensor dim sharded over several axes is ``Shard(d)`` on each, in mesh
    order (the spec's major-to-minor order, as the production meshes
    list "pod" before "data"). An axis of size 1 replicates: a shard over
    it is the whole tensor."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            i = names.index(a)
            if sizes[i] > 1:
                out[i] = Shard(d)
    return out


def to_placements(spec_tree, mesh):
    """Every spec of a tree as its DTensor placements (``to_named``'s
    counterpart); optimizer states map field by field."""
    if isinstance(spec_tree, P):
        return spec_placements(spec_tree, mesh)
    if spec_tree is None:
        return None
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(to_placements(s, mesh) for s in spec_tree))
    if isinstance(spec_tree, dict):
        return {k: to_placements(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return [to_placements(v, mesh) for v in spec_tree]
    raise TypeError(f"not a spec tree: {type(spec_tree)}")


def local_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """One rank's shard shape of a tensor of ``shape`` laid out by
    ``spec`` (every sharded dim divides, as the rules guarantee)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n = _axis_size(mesh, a)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide over {a!r} ({n})")
            out[d] //= n
    return tuple(out)


def make_fsdp_gather_hook(cfg, mesh):
    """ZeRO-3 weight gather: redistribute each layer group's FSDP-stored
    leaves back to their tensor-parallel layout at use, one group at a
    time (the reference's ``with_sharding_constraint``), so the weights
    are all-gathered over "data" instead of the activations being
    resharded. Install with ``transformer.set_layer_param_hook``; the
    group's slices are DTensors."""

    def hook(gp):
        def f(path, leaf):
            p = _path_str(path)                       # pos{i}/ffn/w_gate
            sub = p.split("/", 1)[1] if "/" in p else p
            if _fsdp_eligible(sub):
                s = _layer_param_spec(sub, leaf, cfg, mesh)
                return leaf.redistribute(leaf.device_mesh,
                                         spec_placements(s, mesh))
            return leaf
        return tree_map_with_path(f, gp)

    return hook
