"""Parameterized traces of the audited entry points for the cost model.

``fixtures`` traces each entry once at fixed probe dims; the cost model
needs the SAME entry points re-traceable at several sizes so the scaling
fits can recover leading exponents. Every builder returns ``(fn, args)``
with small real CPU arguments; ``trace_entry`` traces ``fn`` on FAKE
tensors made from them (``make_fx(tracing_mode="fake")``), so every
intermediate, an (N,N) matrix at N=2048 included, costs no memory. The
arguments report the CPU, so every kernel wrapper takes its plain
version, the math the cost model prices.

One deliberate divergence from the fixtures, the reference's own: the
graph entries (``sqmd.build_graph`` / ``sqmd.build_graph_delta``) stage
the candidate POOL concretely, as the runtime does
(``graph.candidate_pool``): the pool's size depends on the quality
values, so the builders compute it from a fixed probe quality profile
and trace the selection over it (``graph.select_from_pool``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.analysis import fixtures

# reference dims the budgets are pinned at; every structural dim distinct
# so shapes in reports name their dimension (the reference's)
DEFAULT_DIMS: Dict[str, int] = {
    "n": 64,        # clients
    "r": 8,         # reference-set rows
    "c": 10,        # classes
    "batch": 3,     # local batch
    "feat": 7,      # input features
    "hidden": 16,   # MLP hidden width
    "u": 2,         # uploads per delta round
    "q": 8,         # quality pool size
    "k": 4,         # neighbors
    "b": 8,         # serve batch
}

# the axis each entry's scaling fit sweeps, and the sweep values (the
# reference's): the N²-class entries sweep to 2048 so the quadratic term
# dominates the Θ(N) terms inside the window; the IVF entries sweep wider,
# their point being the sub-quadratic tail
SCALE_AXES: Dict[str, Tuple[str, Tuple[int, ...]]] = {
    "cohort_step": ("n", (32, 64, 128, 256)),
    "cohort_messenger_upload": ("n", (32, 64, 128, 256)),
    "cohort_messenger_upload[int8]": ("n", (32, 64, 128, 256)),
    "sqmd.grade": ("n", (64, 128, 256, 512)),
    "sqmd.build_graph": ("n", (256, 512, 1024, 2048)),
    "sqmd.build_graph_delta": ("n", (256, 512, 1024, 2048)),
    "divergence_matrix": ("n", (256, 512, 1024, 2048)),
    "int8_dequant_kl": ("n", (256, 512, 1024, 2048)),
    "centroid_assign": ("n", (256, 1024, 4096, 16384)),
    "ivf_search": ("n", (256, 1024, 4096, 16384)),
    "serve_step": ("b", (8, 16, 32, 64)),
}

CPU = torch.device("cpu")


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator(device=CPU).manual_seed(seed)


def _f32(*shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32)


def _logp(*shape) -> torch.Tensor:
    return torch.log_softmax(torch.randn(shape, generator=_gen(1)), -1)


def _step_args(model, state0, d):
    from repro_torch.optim import state_tensors
    n, b, f = d["n"], d["batch"], d["feat"]
    params = [p.detach().clone().requires_grad_(True)
              for p in model.parameters()]
    return (params, [t.clone() for t in state_tensors(state0)],
            _f32(n, b, f), torch.zeros((n, b), dtype=torch.long),
            _f32(d["r"], f), torch.full((n, d["r"], d["c"]), 1.0 / d["c"]),
            torch.ones((n,), dtype=torch.bool))


def _mlp(d):
    from repro_torch.models.mlp import CohortMLP, MLPConfig
    return CohortMLP(MLPConfig("cost-probe", d["feat"], (d["hidden"],),
                               d["c"]), d["n"], device=CPU,
                     generator=_gen(0))


# --------------------------------------------------------------------------
# builders: name -> (fn, args)
# --------------------------------------------------------------------------

def _cohort_step(d):
    from repro_torch.optim import adam
    model = _mlp(d)
    optimizer = adam(1e-3)
    state0 = optimizer.init([p.detach() for p in model.parameters()])
    return (fixtures.step_wrapper(model, optimizer, state0),
            _step_args(model, state0, d))


def _messenger_upload(codec_spec):
    def build(d):
        from repro_torch.core import wire
        model = _mlp(d)
        codec = wire.as_codec(codec_spec) if codec_spec else None
        return (fixtures.upload_wrapper(model, codec),
                ([p.detach() for p in model.parameters()],
                 _f32(d["r"], d["feat"])))
    return build


def _grade(d):
    from repro_torch.core.quality import quality_scores
    return (lambda repo_logp, labels: quality_scores(repo_logp, labels),
            (_logp(d["n"], d["r"], d["c"]),
             torch.zeros((d["r"],), dtype=torch.long)))


def _concrete_pool(d):
    """The runtime's concrete candidate staging: a fixed probe quality
    profile through the real mask and pool."""
    from repro_torch.core import graph as graph_mod
    from repro_torch.core.quality import candidate_mask
    n = d["n"]
    quality = torch.from_numpy(np.linspace(0.1, 3.0, n, dtype=np.float32))
    staged = graph_mod.candidate_pool(
        candidate_mask(quality, torch.ones((n,), dtype=torch.bool), d["q"]),
        d["k"])
    if staged is None:      # q = 0: cannot happen with DEFAULT_DIMS
        raise ValueError("probe candidate pool is empty")
    return staged


def _select(div, pool, valid, k):
    """``select_neighbors_from_div`` over a staged pool: the tensors of
    the CollaborationGraph the policy returns (the divergence it was
    built from, the similarity, neighbors, W and the slot weights)."""
    from repro_torch.core import graph as graph_mod
    from repro_torch.core.similarity import similarity_matrix
    sim = similarity_matrix(div)
    return (div, sim) + tuple(graph_mod.select_from_pool(sim, pool, valid,
                                                         k))


def _build_graph(d):
    from repro_torch.core import similarity
    pool, valid = _concrete_pool(d)

    def fn(repo_logp, pool, valid):
        return _select(similarity.divergence_matrix(repo_logp), pool, valid,
                       d["k"])

    return fn, (_logp(d["n"], d["r"], d["c"]), pool, valid)


def _build_graph_delta(d):
    from repro_torch.core import similarity
    pool, valid = _concrete_pool(d)
    up = np.zeros(d["n"], bool)
    up[:d["u"]] = True

    def fn(div_cache, repo_logp, pool, valid):
        div = similarity.update_divergence_cache(div_cache, repo_logp, up)
        return _select(div, pool, valid, d["k"])

    return fn, (_f32(d["n"], d["n"]), _logp(d["n"], d["r"], d["c"]), pool,
                valid)


def _divergence_matrix(d):
    from repro_torch.core import similarity
    return (lambda repo_logp: similarity.divergence_matrix(repo_logp),
            (_logp(d["n"], d["r"], d["c"]),))


def _u8(*shape) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=_gen(2))


def _int8_dequant_kl(d):
    from repro_torch.kernels import ops
    n, r, c = d["n"], d["r"], d["c"]
    return (lambda q, scale, zp: ops.int8_pairwise_kl(q, scale, zp),
            (_u8(n, r, c), torch.full((n, r), 0.05), _f32(n, r)))


def _ivf_dims(d):
    """Derived IVF population shapes, as ``NeighborIndex`` defaults them:
    ncent = isqrt(n) coarse clusters, n_probe = isqrt(ncent) probed, so
    the candidate strip width is n_probe · ceil(n/ncent) ~ n^{3/4}."""
    n = d["n"]
    ncent = max(1, math.isqrt(n))
    probe = max(1, math.isqrt(ncent))
    return ncent, min(n, probe * -(-n // ncent))


def _recon(q, scale, lse):
    """``NeighborIndex._recon_logp``: logp = q·scale − lse."""
    return q.float() * scale[..., None] - lse[..., None]


def _centroid_assign(d):
    from repro_torch.kernels import ops
    u, r, c = d["u"], d["r"], d["c"]
    ncent, _ = _ivf_dims(d)

    def fn(q, scale, lse, centroids):
        # the exact upload-vs-centroid strip: NeighborIndex._centroid_div
        return ops.pairwise_kl_pair(_recon(q, scale, lse), centroids)

    return fn, (_u8(u, r, c), torch.full((u, r), 0.05), _f32(u, r),
                _logp(ncent, r, c))


def _ivf_search(d):
    from repro_torch.kernels import ops
    u, r, c = d["u"], d["r"], d["c"]
    ncent, cand = _ivf_dims(d)

    def strip(qa, sa, la, qb, sb, lb):
        # NeighborIndex._strip: the int8 strip on the stored lse
        return ops.int8_pairwise_kl_pair(
            qa, sa, torch.zeros_like(sa), qb, sb, torch.zeros_like(sb),
            lse_a=la, lse_b=lb)

    def fn(qu, su, lu, centroids, qc, sc, lc):
        # assignment strip + the forward and reverse candidate strips: one
        # NeighborIndex.update search round
        d_cent = ops.pairwise_kl_pair(_recon(qu, su, lu), centroids)
        return d_cent, strip(qu, su, lu, qc, sc, lc), \
            strip(qc, sc, lc, qu, su, lu)

    return fn, (_u8(u, r, c), torch.full((u, r), 0.05), _f32(u, r),
                _logp(ncent, r, c), _u8(cand, r, c),
                torch.full((cand, r), 0.05), _f32(cand, r))


def _serve_step(d):
    from repro_torch.serve import engine
    model = _mlp(d)
    params = {k: p.detach() for k, p in model.named_parameters()}
    b = d["b"]
    return (lambda params, rows, xs: engine.serve_step(model, params, rows,
                                                       xs),
            (params, torch.zeros((b,), dtype=torch.long),
             _f32(b, d["feat"])))


def _zoo_cohort_step(family: str):
    """cohort_step through a REGISTERED zoo family (its real builder and
    its own default optimizer), so every architecture's training step
    carries its own budget."""
    def build(d):
        from repro_torch.models.zoo import get_family
        spec = get_family(family)
        model = spec.builder(d["feat"], d["c"])(d["n"], device=CPU,
                                                generator=_gen(0))
        optimizer = spec.make_optimizer()
        state0 = optimizer.init([p.detach() for p in model.parameters()])
        return (fixtures.step_wrapper(model, optimizer, state0),
                _step_args(model, state0, d))
    return build


ENTRY_BUILDERS: Dict[str, Callable] = {
    "cohort_step": _cohort_step,
    "cohort_messenger_upload": _messenger_upload(None),
    "cohort_messenger_upload[int8]": _messenger_upload("int8"),
    "sqmd.grade": _grade,
    "sqmd.build_graph": _build_graph,
    "sqmd.build_graph_delta": _build_graph_delta,
    "divergence_matrix": _divergence_matrix,
    "int8_dequant_kl": _int8_dequant_kl,
    "centroid_assign": _centroid_assign,
    "ivf_search": _ivf_search,
    "serve_step": _serve_step,
}


def _register_zoo_entries() -> None:
    """One ``cohort_step[<family>]`` entry per registered zoo family, so a
    newly registered architecture gets a budget and a Θ(n) sweep without
    touching this file."""
    from repro_torch.models.zoo import registered_families
    for fam in registered_families():
        name = f"cohort_step[{fam}]"
        ENTRY_BUILDERS[name] = _zoo_cohort_step(fam)
        SCALE_AXES[name] = ("n", (32, 64, 128, 256))


_register_zoo_entries()


def trace_entry(name: str, **overrides) -> torch.fx.GraphModule:
    """The aten graph of entry ``name`` at DEFAULT_DIMS overridden by
    ``overrides``, traced on fake tensors."""
    from repro_torch.analysis import graphlib
    builder = ENTRY_BUILDERS.get(name)
    if builder is None:
        raise KeyError(f"unknown cost entry {name!r}; known: "
                       f"{sorted(ENTRY_BUILDERS)}")
    dims = dict(DEFAULT_DIMS)
    bad = set(overrides) - set(dims)
    if bad:
        raise KeyError(f"unknown dims {sorted(bad)}; known: {sorted(dims)}")
    dims.update(overrides)
    fn, args = builder(dims)
    return graphlib.trace(fn, *args, fake=True, functional=False)


def entry_names() -> Tuple[str, ...]:
    return tuple(sorted(ENTRY_BUILDERS))
