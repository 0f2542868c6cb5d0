"""Placement auditors: shard isolation and shape bucketing.

The reference lowers its sharded paths and counts collectives in the
partitioned HLO; the port has no partitioner, so it audits the calls that
run. A client mesh here is a tuple of devices with no process group
(``repro_torch.sharding``), and on the CPU every entry is the same
device, so isolation is shown from values:

  * ``client-axis-collectives`` — the zero-cross-shard-traffic claim.
    ``sharded_cohort_step`` and ``sharded_messenger_upload`` on an
    8-entry mesh: perturbing one shard's rows (params, optimizer state,
    data, targets, batch indices, mask) must leave every other shard's
    outputs bit for bit as they were. ``divergence_matrix(mesh=)``: a spy
    on ``ops.pairwise_kl_pair`` must see one call a mesh entry, on that
    entry's device, reading its own row block and the whole (broadcast)
    repository, and the result's rows must be that call's strip.
  * ``jit-cache-bucketing`` — the delta update's strips must reach the B1
    entry at one row count a power-of-two bucket
    (``core.similarity._bucket_rows``), not one a distinct upload count.
  * ``serve-jit-bucketing`` — ``QueryEngine.serve`` must reach its
    forward at one batch shape a power-of-two bucket.

Shape buckets matter on the card as jit caches do on the TPU: each
distinct shape is a separate plan (a GEMM grid, an allocator block).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import (Callable, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.analysis import fixtures
from repro_torch.analysis.registry import (AnalysisContext, Violation,
                                           register_rule)

MESH_SIZE = 8
# the probe cohort on the mesh: 13 real clients -> 3 ghost rows -> 2 rows a
# shard, the last shard half ghost
SHARD_CLIENTS = 13


# --------------------------------------------------------------------------
# call spies
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Call:
    args: tuple
    out: object


@contextlib.contextmanager
def spy_calls(module, attr: str) -> Iterator[List[Call]]:
    """Swap ``module.attr`` for a recording wrapper (restored on exit).
    Callers that reach the function through the module attribute, as the
    port's callers of ``ops`` and ``serve.engine`` do, are recorded."""
    real = getattr(module, attr)
    calls: List[Call] = []

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(Call(args, out))
        return out

    setattr(module, attr, spy)
    try:
        yield calls
    finally:
        setattr(module, attr, real)


# --------------------------------------------------------------------------
# shard isolation
# --------------------------------------------------------------------------

def isolation_violations(where: str, run: Callable[[Optional[int]], list],
                         n_shards: int,
                         rule: str = "client-axis-collectives"
                         ) -> List[Violation]:
    """``run(j)`` runs the sharded path with shard ``j``'s rows perturbed
    (``None``: unperturbed) and returns one list of output tensors a
    shard. Any shard whose outputs move when ANOTHER shard's rows change
    reads rows that are not its own."""
    base = run(None)
    out = []
    for j in range(n_shards):
        got = run(j)
        for k in range(n_shards):
            if k == j:
                continue
            same = len(got[k]) == len(base[k]) and all(
                torch.equal(a, b) for a, b in zip(got[k], base[k]))
            if not same:
                out.append(Violation(
                    rule, f"{where}#shard{k}<-shard{j}",
                    f"shard {k}'s outputs change when shard {j}'s rows "
                    f"change: the client axis must partition with no "
                    f"cross-shard traffic"))
    return out


def strip_violations(where: str, calls: Sequence[Call],
                     logp: torch.Tensor, result: torch.Tensor, mesh,
                     rule: str = "client-axis-collectives"
                     ) -> List[Violation]:
    """The row-strip rebuild's calls (spied on ``ops.pairwise_kl_pair``):
    one a mesh entry, on its device, reading its own row block of the
    ghost-padded repository and the whole repository, its strip landing
    on its rows of ``result``."""
    from repro_torch.sharding import ghost_pad_stack, ghost_rows
    n = logp.shape[0]
    padded = ghost_pad_stack(logp, ghost_rows(n, mesh.size))
    rows = padded.shape[0] // mesh.size
    if len(calls) != mesh.size:
        return [Violation(rule, f"{where}#calls",
                          f"{len(calls)} strip calls for a {mesh.size}-entry "
                          f"mesh: each entry computes exactly its own "
                          f"strip")]
    out = []
    for i, (call, dev) in enumerate(zip(calls, mesh.devices)):
        a, b = call.args[:2]
        block = padded[i * rows:(i + 1) * rows]
        ok = (a.device == dev and b.device == dev
              and torch.equal(a.cpu(), block.cpu())
              and torch.equal(b.cpu(), logp.cpu()))
        if not ok:
            out.append(Violation(
                rule, f"{where}#strip{i}",
                f"strip {i} on {a.device} read rows other than its block "
                f"{i * rows}:{(i + 1) * rows} against the broadcast "
                f"repository"))
            continue
        lo, hi = i * rows, min((i + 1) * rows, n)
        if hi > lo and not torch.equal(result[lo:hi].cpu(),
                                       call.out[:hi - lo].cpu()):
            out.append(Violation(
                rule, f"{where}#strip{i}",
                f"rows {lo}:{hi} of the rebuilt matrix are not strip {i}"))
    return out


def probe_mesh(device: str, size: int = MESH_SIZE):
    """A ``size``-entry client mesh: entries of the CPU, or of the first
    card repeated (the engines' ``mesh=`` seam), so one card runs it."""
    from repro_torch.sharding import ClientMesh, make_client_mesh
    if device == "cpu":
        return make_client_mesh(size, device="cpu")
    return ClientMesh((torch.device("cuda", 0),) * size)


def _probe_cohort(mesh):
    """A ghost-padded probe cohort placed on ``mesh``, with its batch
    indices, targets and trainable mask over the padded rows."""
    from repro_torch.core.client import Cohort
    from repro_torch.sharding import place_cohort_stacks
    g = fixtures.gen(31)
    n = SHARD_CLIENTS
    model, optimizer, state = fixtures.probe_module(n)
    data = {"x": torch.randn((n, fixtures.SAMPLES, fixtures.FEATURES),
                             generator=g),
            "y": torch.randint(0, fixtures.CLASSES, (n, fixtures.SAMPLES),
                               generator=g)}
    coh = Cohort.whole("probe", model, state, np.arange(n), data, optimizer)
    place_cohort_stacks(coh, mesh)
    idx = torch.randint(0, fixtures.SAMPLES, (n, fixtures.BATCH),
                        generator=g)
    targets = torch.softmax(torch.randn((coh.n_rows, fixtures.REF,
                                         fixtures.CLASSES), generator=g), -1)
    trainable = torch.arange(coh.n_rows) < n
    trainable[1] = False                       # one frozen real client
    ref_x = torch.randn((fixtures.REF, fixtures.FEATURES), generator=g)
    return coh, idx, targets, trainable, ref_x


def _perturb_shard(coh, idx, targets, trainable, j: int) -> None:
    """New values in every row of shard ``j``, in place."""
    from repro_torch.optim import state_tensors
    g = fixtures.gen(100 + j)
    sh = coh.shards[j]
    lo, hi = sh.start, sh.start + sh.n_rows
    dev = sh.device
    with torch.no_grad():
        for p in sh.model.parameters():
            p.add_(torch.randn(p.shape, generator=g).to(dev))
        for t in state_tensors(sh.opt_state):
            if t.is_floating_point():
                t.add_(torch.rand(t.shape, generator=g).to(dev))
            else:
                t.add_(1)
        sh.data["x"].add_(torch.randn(sh.data["x"].shape,
                                      generator=g).to(dev))
        sh.data["y"].copy_(torch.randint(0, fixtures.CLASSES,
                                         sh.data["y"].shape, generator=g))
    targets[lo:hi] = torch.softmax(
        torch.randn(targets[lo:hi].shape, generator=g), -1)
    real = slice(min(lo, coh.n_clients), min(hi, coh.n_clients))
    idx[real] = torch.randint(0, fixtures.SAMPLES, idx[real].shape,
                              generator=g)
    trainable[real] = ~trainable[real]


def step_isolation(step=None, device: str = "cuda") -> List[Violation]:
    """Shard isolation of ``step`` (default the port's
    ``sharded_cohort_step``) on an 8-entry mesh of ``device``."""
    from repro_torch.core.client import sharded_cohort_step
    from repro_torch.optim import state_tensors
    step = step or sharded_cohort_step
    mesh = probe_mesh(device)
    case = _probe_cohort(mesh)

    def run(j: Optional[int]) -> list:
        coh, idx, targets, trainable, ref_x = copy.deepcopy(case)
        if j is not None:
            _perturb_shard(coh, idx, targets, trainable, j)
        step(coh, idx, ref_x, targets, trainable, 0.5, True)
        return [[p.detach() for p in sh.model.parameters()]
                + state_tensors(sh.opt_state) for sh in coh.shards]

    return isolation_violations("sharded_cohort_step", run, mesh.size)


def upload_isolation(upload=None, device: str = "cuda") -> List[Violation]:
    """Shard isolation of ``upload`` (default the port's
    ``sharded_messenger_upload``, int8 wire) on an 8-entry mesh."""
    from repro_torch.core.client import sharded_messenger_upload
    upload = upload or sharded_messenger_upload
    mesh = probe_mesh(device)
    case = _probe_cohort(mesh)

    def run(j: Optional[int]) -> list:
        coh, idx, targets, trainable, ref_x = copy.deepcopy(case)
        if j is not None:
            _perturb_shard(coh, idx, targets, trainable, j)
        parts, rows = upload(coh, ref_x, "int8", mesh.devices[0])
        by_shard = [[] for _ in coh.shards]
        for part, ids in zip(parts, rows):
            k = next(i for i, sh in enumerate(coh.shards)
                     if sh.start <= ids[0] < sh.start + sh.n_rows)
            by_shard[k] = [part.arrays[key] for key in sorted(part.arrays)]
        return by_shard

    return isolation_violations("sharded_messenger_upload", run, mesh.size)


def divergence_isolation(fn=None, device: str = "cuda",
                         n: int = SHARD_CLIENTS) -> List[Violation]:
    """The row-strip rebuild of ``fn`` (default the port's
    ``divergence_matrix``) on an 8-entry mesh, spied on its B1 entry."""
    from repro_torch.core import similarity
    from repro_torch.kernels import ops
    fn = fn or similarity.divergence_matrix
    mesh = probe_mesh(device)
    logp = torch.log_softmax(torch.randn(
        (n, fixtures.REF, fixtures.CLASSES), generator=fixtures.gen(37)),
        -1).to(mesh.devices[0])
    with spy_calls(ops, "pairwise_kl_pair") as calls:
        result = fn(logp, mesh=mesh)
    return strip_violations("divergence_matrix[mesh]", calls, logp, result,
                            mesh)


# --------------------------------------------------------------------------
# shape bucketing
# --------------------------------------------------------------------------

def bucket_violations(where: str, signatures: Sequence[Tuple],
                      max_shapes: int, rule: str = "jit-cache-bucketing"
                      ) -> List[Violation]:
    """At most ``max_shapes`` distinct call signatures (operand shapes)
    may reach a spied entry during a replay."""
    distinct = sorted(set(signatures))
    if len(distinct) > max_shapes:
        return [Violation(
            rule, where,
            f"{len(distinct)} distinct shapes {distinct} for a replay that "
            f"should hit at most {max_shapes} buckets: pad dynamic "
            f"dimensions to power-of-two buckets "
            f"(core.similarity._bucket_rows idiom)")]
    return []


# replayed upload counts vs their power-of-two buckets {1, 2, 4, 8}
REPLAY_UPLOADS: Sequence[int] = (1, 2, 3, 5, 6, 7)
REPLAY_BUCKETS = 4


def delta_signatures(n: int = 16, r: int = 6, device: str = "cuda"
                     ) -> List[Tuple]:
    """Replay REPLAY_UPLOADS through the delta update at (n, r) and return
    each B1 call's signature: its operands' shapes, in sorted order (the
    row strip and the column strip of one bucket are one signature)."""
    from repro_torch.core import similarity
    from repro_torch.kernels import ops
    logp = torch.log_softmax(torch.randn(
        (n, r, fixtures.CLASSES), generator=fixtures.gen(21)) * 2.0,
        -1).to(device)
    cache = similarity.divergence_matrix(logp)
    with spy_calls(ops, "pairwise_kl_pair") as calls:
        for u in REPLAY_UPLOADS:
            mask = np.zeros(n, bool)
            mask[:u] = True
            similarity.update_divergence_cache(cache, logp, mask)
    return [tuple(sorted(tuple(a.shape) for a in c.args[:2]))
            for c in calls]


def serve_signatures(max_batch: int = 9, device: str = "cuda"
                     ) -> List[Tuple]:
    """Serve every batch size 1..max_batch through ``QueryEngine.serve``
    and return the feature shape each forward was given."""
    from types import SimpleNamespace

    from repro_torch.core.client import Cohort
    from repro_torch.models.mlp import CohortMLP, MLPConfig
    from repro_torch.serve import QueryEngine, SnapshotStore
    from repro_torch.serve import engine as engine_mod
    n, feat = 6, 4
    dev = torch.device(device)
    model = CohortMLP(MLPConfig("probe-serve", feat, (8,), 3), n,
                      device=fixtures.CPU, generator=fixtures.gen(23)).to(dev)
    coh = Cohort.whole("probe-serve", model, None, np.arange(n),
                       {"y": torch.zeros((n, 1), device=dev)}, None)
    fed = SimpleNamespace(n_clients=n, device=dev, cohorts=[coh])
    store = SnapshotStore()
    store.publish(fed, t=0.0)
    qe = QueryEngine(store)
    with spy_calls(engine_mod, "serve_step") as calls:
        for b in range(1, max_batch + 1):
            qe.serve([i % n for i in range(b)],
                     np.zeros((b, feat), np.float32), t=0.0)
    return [tuple(c.args[3].shape) for c in calls]


# --------------------------------------------------------------------------
# registered rules
# --------------------------------------------------------------------------

@register_rule("client-axis-collectives", family="placement")
def client_axis_collectives(ctx: AnalysisContext) -> Iterable[Violation]:
    """No shard reads another shard's rows (8-entry client mesh).

    The sharded cohort step and messenger upload read only their own
    rows; each strip of the sharded divergence rebuild reads only its
    block and the broadcast repository."""
    yield from step_isolation(device=ctx.device)
    yield from upload_isolation(device=ctx.device)
    yield from divergence_isolation(device=ctx.device)


@register_rule("jit-cache-bucketing", family="placement")
def jit_cache_bucketing(ctx: AnalysisContext) -> Iterable[Violation]:
    """The delta update reaches B1 at one shape a power-of-two bucket.

    Replays upload counts 1-7 through the incremental divergence update,
    spied on ``ops.pairwise_kl_pair``."""
    yield from bucket_violations("update_divergence_cache",
                                 delta_signatures(device=ctx.device),
                                 REPLAY_BUCKETS)


@register_rule("serve-jit-bucketing", family="placement")
def serve_jit_bucketing(ctx: AnalysisContext) -> Iterable[Violation]:
    """The serve forward sees one batch shape a power-of-two bucket.

    Serves every batch size 1..9: at most {1, 2, 4, 8, 16}."""
    yield from bucket_violations("serve.engine.serve_step",
                                 serve_signatures(device=ctx.device), 5,
                                 rule="serve-jit-bucketing")
