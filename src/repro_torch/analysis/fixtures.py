"""Tiny probe fixtures and the traced entry points the rules audit.

The auditors inspect the REAL entry points (``core.client``'s cohort
step and messenger upload, the SQMD policy hooks, the divergence
rebuild, the wire codecs, the batch draw) on deliberately tiny,
deliberately odd-shaped inputs, so

  * tracing is fast (a fraction of a second an entry point),
  * every structural dimension is DISTINCT (clients 6, padded rows 8,
    real rows 5, batch 3, samples 11, reference 4, classes 3, features
    7), so a shape showing up in a random draw names the dimension it
    came from.

Every input is drawn from an explicit ``torch.Generator``. The server
entries run on the CPU, where each kernel wrapper takes its plain
version (the counterpart of the reference's ``backend="jnp"`` oracle).
An entry is traced (``graph``) and spied on (``draws``) on demand, each
once a run: both are cached on the entry, the entries on the
``AnalysisContext``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.nn.utils import stateless

from repro_torch.analysis import graphlib

# probe dimensions, all pairwise distinct (see module docstring)
N_CLIENTS = 6        # server population
N_ROWS = 8           # padded cohort rows (mesh-multiple)
N_REAL = 5           # real cohort rows under padding
BATCH = 3
SAMPLES = 11         # per-client shard length
REF = 4              # reference-set size
CLASSES = 3
FEATURES = 7

CPU = torch.device("cpu")


@dataclasses.dataclass
class TracedEntry:
    """One audited entry point: ``fn(*make_args())`` runs it on fresh
    inputs (fresh generators included), plus the audit metadata."""
    name: str
    fn: Callable
    make_args: Callable[[], tuple]
    # inside the wire-codec boundary: precision drops are the point
    codec_boundary: bool = False
    # (padded_dim, real_dim) when the entry runs on a ghost-padded stack
    padded: Optional[Tuple[int, int]] = None
    # (fn, make_args) traced for the graph instead of the entry itself,
    # for an entry that draws from a generator argument: a generator
    # cannot be a graph argument on every torch, so the graph starts
    # after the draw (the spy still runs the whole entry)
    graph_of: Optional[Tuple[Callable, Callable[[], tuple]]] = None
    _graph: Optional[torch.fx.GraphModule] = None
    _draws: Optional[List[graphlib.Draw]] = None

    @property
    def graph(self) -> torch.fx.GraphModule:
        """The entry's functional aten graph (traced once)."""
        if self._graph is None:
            fn, make_args = self.graph_of or (self.fn, self.make_args)
            self._graph = graphlib.trace(fn, *make_args())
        return self._graph

    @property
    def draws(self) -> List[graphlib.Draw]:
        """The random ops one run of the entry makes (spied once)."""
        if self._draws is None:
            self._draws = graphlib.spy_draws(self.fn, *self.make_args())
        return self._draws


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device=CPU).manual_seed(seed)


def probe_module(n_rows: int = N_CLIENTS):
    """A stacked probe MLP cohort of ``n_rows`` clients, its Adam, and
    Adam's initial state."""
    from repro_torch.models.mlp import CohortMLP, MLPConfig
    from repro_torch.optim import adam
    model = CohortMLP(MLPConfig("probe", FEATURES, (8,), CLASSES), n_rows,
                      device=CPU, generator=gen(7))
    optimizer = adam(1e-3)
    state = optimizer.init([p.detach() for p in model.parameters()])
    return model, optimizer, state


def _param_names(model) -> List[str]:
    return [k for k, _ in model.named_parameters()]


def step_wrapper(model, optimizer, state0):
    """``cohort_step`` over ``model`` as a function of tensors:
    ``wrapper(params, opt_state, bx, by, ref_x, targets, trainable)``
    takes the params and the optimizer state (shaped like ``state0``) as
    lists of tensors and returns ``(params after the step, state after
    it, loss)``."""
    from repro_torch.core import client
    from repro_torch.optim import state_tensors
    from repro_torch.sharding import map_tensors
    names = _param_names(model)

    def wrapper(params, opt_state, bx, by, ref_x, targets, trainable):
        it = iter(opt_state)
        state = map_tensors(lambda _: next(it), state0)
        with stateless._reparametrize_module(model,
                                             dict(zip(names, params))):
            new_state, loss = client.cohort_step(
                model, optimizer, state, bx, by, ref_x, targets, trainable,
                0.5, True)
            return (list(model.parameters()), state_tensors(new_state),
                    loss)

    return wrapper


def upload_wrapper(model, codec):
    """``cohort_messenger_upload`` over ``model`` as a function of its
    params (a list) and the reference inputs; a payload's tensors come
    back as a dict."""
    from repro_torch.core import wire
    from repro_torch.core.client import cohort_messenger_upload
    names = _param_names(model)

    def fn(params, ref_x):
        with stateless._reparametrize_module(model,
                                             dict(zip(names, params))):
            out = cohort_messenger_upload(model, ref_x, codec=codec)
        return dict(out.arrays) if isinstance(out, wire.Payload) else out

    return fn


def cohort_step_probe():
    """The cohort step arranged for the masked-update audit: returns
    ``(wrapper, make_args, leaf_counts, arg_names)``: ``step_wrapper`` of
    the probe cohort, fresh arguments for it, and each argument's tensor
    count (its placeholders)."""
    from repro_torch.optim import state_tensors

    model, optimizer, state0 = probe_module()
    names = _param_names(model)
    wrapper = step_wrapper(model, optimizer, state0)

    def make_args():
        g = gen(8)
        params = [p.detach().clone().requires_grad_(True)
                  for p in model.parameters()]
        return (params, [t.clone() for t in state_tensors(state0)],
                torch.randn((N_CLIENTS, BATCH, FEATURES), generator=g),
                torch.randint(0, CLASSES, (N_CLIENTS, BATCH), generator=g),
                torch.randn((REF, FEATURES), generator=g),
                torch.full((N_CLIENTS, REF, CLASSES), 1.0 / CLASSES),
                torch.ones((N_CLIENTS,), dtype=torch.bool))

    leaf_counts = [len(names), len(state_tensors(state0))] + [1] * 5
    arg_names = ("params", "opt_state", "bx", "by", "ref_x", "targets",
                 "trainable")
    return wrapper, make_args, leaf_counts, arg_names


def _probe_server():
    from repro_torch.core import similarity
    from repro_torch.core.server import init_server, upload_messengers
    g = gen(11)
    logp = torch.log_softmax(
        torch.randn((N_CLIENTS, REF, CLASSES), generator=g) * 2.0, dim=-1)
    st = init_server(N_CLIENTS, REF, CLASSES, device=CPU)
    st = upload_messengers(st, logp, torch.ones((N_CLIENTS,), dtype=bool))
    # a warm divergence cache, so the delta path has something to scatter
    # into (the engine's cache tracks the repository)
    st = st._replace(div_cache=similarity.divergence_matrix(st.repo_logp))
    labels = torch.randint(0, CLASSES, (REF,), generator=gen(12))
    return st, labels


def _sqmd_policy():
    from repro_torch.core.policies.sqmd import SQMDPolicy
    from repro_torch.core.protocols import Protocol
    return SQMDPolicy(Protocol("sqmd", q=4, k=2))


def build_entries(ctx) -> Dict[str, TracedEntry]:
    """Every audited entry point, cached on the context (traced and
    spied on lazily)."""
    if "entries" in ctx.cache:
        return ctx.cache["entries"]  # type: ignore[return-value]

    from repro_torch.core import similarity, wire
    from repro_torch.data import pipeline

    entries: Dict[str, TracedEntry] = {}

    def add(name: str, fn, make_args, codec_boundary: bool = False,
            padded: Optional[Tuple[int, int]] = None,
            graph_of=None) -> None:
        entries[name] = TracedEntry(name, fn, make_args,
                                    codec_boundary=codec_boundary,
                                    padded=padded, graph_of=graph_of)

    # --- cohort step + messenger upload ----------------------------------
    wrapper, make_step_args, _, _ = cohort_step_probe()
    add("cohort_step", wrapper, make_step_args)

    model, _, _ = probe_module()

    def upload_args():
        return ([p.detach().clone() for p in model.parameters()],
                torch.randn((REF, FEATURES), generator=gen(9)))

    add("cohort_messenger_upload", upload_wrapper(model, None), upload_args)
    add("cohort_messenger_upload[int8]", upload_wrapper(model, wire.Int8()),
        upload_args, codec_boundary=True)

    # --- server round pieces (the plain versions: the CPU path) ----------
    st, labels = _probe_server()
    pol = _sqmd_policy()
    quality = torch.ones((N_CLIENTS,), dtype=torch.float32)
    add("sqmd.grade", lambda s, y: pol.grade(s, y), lambda: (st, labels))
    add("sqmd.build_graph", lambda s, q: pol.build_graph(s, q),
        lambda: (st, quality))
    up_mask = torch.zeros((N_CLIENTS,), dtype=torch.bool)
    up_mask[:2] = True
    add("sqmd.build_graph_delta",
        lambda s, q: pol.build_graph_delta(s, q, up_mask.numpy()),
        lambda: (st, quality))
    graph = pol.build_graph(st, quality)
    add("sqmd.emit_targets", lambda s, g: pol.emit_targets(s, g),
        lambda: (st, graph))

    # --- similarity -------------------------------------------------------
    add("divergence_matrix", lambda lp: similarity.divergence_matrix(lp),
        lambda: (st.repo_logp,))

    # --- wire codecs (the sanctioned precision boundary) ------------------
    def roundtrip(codec):
        return lambda x: codec.decode(codec.encode(x, domain="log"))

    for codec_name in ("dense16", "int8", "topk:2"):
        add(f"wire[{codec_name}].roundtrip",
            roundtrip(wire.as_codec(codec_name)), lambda: (st.repo_logp,),
            codec_boundary=True)

    # --- the batch draw (PRNG discipline) ---------------------------------
    def data(rows: int):
        g = gen(13)
        return (torch.randn((rows, SAMPLES, FEATURES), generator=g),
                torch.randint(0, CLASSES, (rows, SAMPLES), generator=g))

    def add_batch(name: str, gather, draw_rows: int, data_rows: int,
                  padded=None):
        """The draw at ``draw_rows`` and the gather from ``data_rows``
        stacked rows; the graph is the gather given the drawn indices."""
        def fn(g, x, y):
            idx = pipeline.draw_batch_indices(g, draw_rows, SAMPLES, BATCH)
            return gather({"x": x, "y": y}, idx)

        def drawn():
            return (pipeline.draw_batch_indices(gen(3), draw_rows, SAMPLES,
                                                BATCH), *data(data_rows))

        add(name, fn, lambda: (gen(3), *data(data_rows)), padded=padded,
            graph_of=(lambda idx, x, y: gather({"x": x, "y": y}, idx),
                      drawn))

    add_batch("cohort_batch", pipeline.cohort_batch, N_CLIENTS, N_CLIENTS)
    add_batch("cohort_batch_padded", pipeline.cohort_batch_padded, N_REAL,
              N_ROWS, padded=(N_ROWS, N_REAL))

    ctx.cache["entries"] = entries
    return entries


def entry_names(ctx) -> List[str]:
    return sorted(build_entries(ctx))
