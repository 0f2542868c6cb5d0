"""Multi-pod dry run: partition every (architecture x input shape) of the
LM zoo on the production meshes, without a card per rank, and emit the
roofline terms. The counterpart of the reference's ``launch/dryrun.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k [--multi-pod] [--out runs/dryrun] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

GSPMD becomes DTensor over a fake process group (``launch/mesh.py``):
one process is rank 0 of the 256 (16x16) or 512 (2x16x16) ranks. Every
param, optimizer-state, batch and cache leaf is a DTensor laid out by
the reference's spec rules (``sharding.py``) whose local shard is a fake
tensor on ``device`` (None: the card), so nothing is allocated. The step
runs eagerly under ``implicit_replication()`` (the models' own
constants, such as positions and the attention's running max, count as
replicated) and ``graph_cost.CostCounter``, which counts rank 0's local
ops and collectives. Outputs are redistributed to their specs, as the
reference's ``out_shardings`` place them.

Each combination writes <out>/<arch>__<shape>__<mesh>.json with the
reference's row: per-device memory, FLOPs, HBM bytes, collective bytes
by kind, the three roofline terms (H100 constants,
``graph_analysis.py``), MODEL_FLOPS and the useful-compute fraction;
``trace_s`` in place of ``lower_s``/``compile_s``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from repro_torch import Device, resolve_device
from repro_torch import sharding as shard
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 input_specs, skip_reason)
from repro_torch.launch.graph_analysis import (analyze_traced,
                                               model_flops_estimate)
from repro_torch.launch.graph_cost import CostCounter
from repro_torch.launch.mesh import (MULTI_POD_SHAPE, POD_SHAPE,
                                     fake_process_group,
                                     make_production_mesh)
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import transformer as tf
from repro_torch.models.common import set_partitioner
from repro_torch.optim import adam, single_model


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tensors (dicts, lists,
    NamedTuples) and its spec tree (``P`` leaves)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, t, s) for t, s in zip(tree, specs)))
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
    raise TypeError(f"unexpected leaf {type(tree)}")


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _locals(tree) -> List[torch.Tensor]:
    from torch.distributed.tensor import DTensor
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in _leaves(tree)]


def distribute(tree, specs, mesh, dev: torch.device):
    """Every (meta) leaf as a DTensor laid out by its spec, its local shard
    an uninitialised tensor on ``dev`` (call inside a FakeTensorMode)."""
    from torch.distributed.tensor import DTensor

    def one(leaf, spec):
        local = torch.empty(shard.local_shape(leaf.shape, spec, mesh),
                            dtype=leaf.dtype, device=dev)
        return DTensor.from_local(local, mesh,
                                  shard.spec_placements(spec, mesh),
                                  run_check=False, shape=leaf.shape,
                                  stride=torch.empty(leaf.shape,
                                                     device="meta").stride())
    return _zip_map(one, tree, specs)


def place(tree, specs, mesh):
    """Redistribute a tree to its specs (``out_shardings``); a plain
    tensor the step built (a cache's positions) is replicated, as
    ``implicit_replication`` took it."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(t, spec):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, shard.spec_placements(spec, mesh))
    return _zip_map(one, tree, specs)


class _Contiguous(torch.autograd.Function):
    """``x`` contiguous, and its gradient made contiguous too: a rank's
    buffers are its own (a chunk DTensor cuts out of a replicated tensor
    is a strided view, and DTensor may hand a strided gradient across a
    region's boundary, which the views of the backward on the far side
    cannot always take)."""

    @staticmethod
    def forward(ctx, x):
        return x.contiguous() if not x.is_contiguous() else x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


class Partitioner:
    """The models' partitioner hook (``models.common.set_partitioner``):
    lays out the activations DTensor's propagation cannot settle, as GSPMD
    settles them, on ``mesh`` under ``policy``.

    * ``pin(x, like)``: ``like``'s placements, or the batch layout (dim 0
      over the batch axes when it divides, replicated elsewhere).
    * ``embed(table, tokens)`` / ``pick(logits, labels)``: vocab-parallel
      lookups, each rank's slice with the other rows masked to 0, a
      Partial sum over "model" (GSPMD's masked gather). DTensor's own
      gather from a vocab-sharded tensor keeps a mask buffer that its
      sharding cache shares across calls (a fake tensor compared by
      value) and cannot apply to the gather's result (an IndexError); its
      index op all-gathers the table.
    * ``attention(fn, q, k, v, q_pos, k_pos, window)``: the attention core
      on each rank's LOCAL heads and keys, as GSPMD partitions it: the
      batch over the batch axes; the heads over "model" when it divides
      the query heads, the rank's key/value heads sliced out of a
      replicated k/v when it does not divide the kv heads (GQA), all
      replicated when it divides neither (the reference replicates those
      archs' attention too). A cache whose sequence is sharded (a
      long_500k request) is attended block by block, the softmax
      combined with all-reduces (distributed flash-decode). DTensor
      itself cannot take the GQA group view of a head-sharded query (an
      uneven unflatten) nor the strided shards einsum's reshapes leave.
    * ``ffn``, ``experts``, ``decode_experts``, ``dropless_experts``: the
      dense FFN, GShard's expert products, decode's chosen experts and the
      dropless sort and grouped products on each rank's columns or
      experts (decode and dropless: the other ranks' choices weighted 0),
      a Partial sum over "model" (Megatron's column/row split; einsum's
      backward on DTensor reaches the same strided shards).
    * ``channels``: a depthwise conv on each rank's channels, its filter
      cut to them; ``local``: a cache packed from each rank's keys;
      ``cache_write``: a decode cache written on the local shard, only by
      the rank holding the slot of a sequence-sharded one (torch 2.11's
      DTensor registers no strategy for ``index_copy_`` or ``roll``, and
      its ``constant_pad_nd`` and expert ``index`` fail on sharded
      meshes).

    Each region's operands enter as contiguous local tensors and leave as
    a DTensor (``_Contiguous``, ``_wrap``); autograd runs through them.
    """

    def __init__(self, mesh, policy=shard.BASELINE):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = dict(zip(self.names, tuple(mesh.shape)))
        self.batch = shard.batch_axes(mesh, policy)
        self.n_batch = math.prod(self.sizes[a] for a in self.batch)
        self.n_model = 1 if "model" in self.batch else \
            self.sizes.get("model", 1)

    def layout(self, x, model_dim: Optional[int] = None,
               partial_model: bool = False) -> list:
        from torch.distributed.tensor import Partial, Replicate, Shard
        split = x.dim() > 0 and x.shape[0] % self.n_batch == 0
        out = []
        for a in self.names:
            if a in self.batch and split and self.sizes[a] > 1:
                out.append(Shard(0))
            elif a == "model" and self.n_model > 1 and model_dim is not None:
                out.append(Shard(model_dim))
            elif a == "model" and self.n_model > 1 and partial_model:
                out.append(Partial())
            else:
                out.append(Replicate())
        return out

    def pin(self, x, like=None):
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        if like is not None:
            if not isinstance(like, DTensor):
                return x
            return x.redistribute(like.device_mesh, like.placements)
        return x.redistribute(self.mesh, self.layout(x))

    def _local(self, t, placements, grad):
        """``t``'s local shard in ``placements`` (``_Contiguous``)."""
        from torch.distributed.tensor import DTensor
        if not isinstance(t, DTensor):
            return t
        return _Contiguous.apply(t.redistribute(self.mesh, placements)
                                 .to_local(grad_placements=grad))

    def attention(self, fn, q, k, v, q_pos, k_pos, window):
        from torch.distributed.tensor import DTensor, Shard
        if not isinstance(q, DTensor):
            return fn(q, k, v, q_pos, k_pos, window)
        h, kvh = q.shape[2], k.shape[2]
        heads = self.n_model > 1 and h % self.n_model == 0
        kv_heads = heads and kvh % self.n_model == 0
        seq = [i for i, p in enumerate(getattr(k, "placements", ()))
               if isinstance(p, Shard) and p.dim == 1]
        qpl = self.layout(q, 2 if heads else None)
        if seq:
            kpl = list(k.placements)
        else:
            kpl = self.layout(k, 2 if kv_heads else None)
        sliced = heads and not kv_heads
        kgrad = self.layout(k, 2 if kv_heads else None, partial_model=sliced)
        ql = self._local(q, qpl, qpl)
        kl = self._local(k, kpl, kgrad)
        vl = self._local(v, kpl, kgrad)
        q_pos, k_pos = _full(q_pos), _full(k_pos)
        if sliced:                        # this rank's kv heads of its q
            r = self.mesh.get_local_rank("model")
            hl, g = h // self.n_model, h // kvh
            lo, hi = (r * hl) // g, ((r + 1) * hl - 1) // g + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        if seq:
            ol = self._flash_decode(ql, kl, vl, q_pos, k_pos, window, seq)
        else:
            ol = fn(ql, kl, vl, q_pos, k_pos, window)
        return self._wrap(ol, qpl,
                          tuple(q.shape[:3]) + (ol.shape[-1],))

    def _wrap(self, local, placements, shape):
        """A region's local result as a DTensor of global ``shape``
        (``_Contiguous``)."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(
            _Contiguous.apply(local), self.mesh, placements,
            run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())

    def _vocab_slice(self, t, dim: int):
        """(lo, rows) of this rank's slice of ``t``'s dim ``dim`` when it
        is sharded over "model", else None."""
        from torch.distributed.tensor import DTensor, Shard
        if not isinstance(t, DTensor) or "model" not in self.names:
            return None
        p = t.placements[self.names.index("model")]
        if not (isinstance(p, Shard) and p.dim == dim):
            return None
        n = t.shape[dim] // self.sizes["model"]
        return self.mesh.get_local_rank("model") * n, n

    def embed(self, table, tokens):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(table, DTensor):
            return table[tokens]
        vs = self._vocab_slice(table, 0)
        il = self._local(tokens, self.layout(tokens), None)
        shape = tuple(tokens.shape) + (table.shape[1],)
        if vs is None:                   # a replicated table: a local lookup
            tpl = [Replicate()] * len(self.names)
            rows = self._local(table, tpl, self._partial_over_batch(
                tpl, tokens))[il]
            return self._wrap(rows, self.layout(tokens), shape)
        lo, n = vs
        tpl = [Shard(0) if a == "model" else Replicate() for a in self.names]
        inside = (il >= lo) & (il < lo + n)
        rows = self._local(table, tpl, self._partial_over_batch(
            tpl, tokens))[torch.clamp(il - lo, 0, n - 1)]
        rows = rows * inside[..., None].to(rows.dtype)
        return self._wrap(rows, self.layout(tokens, partial_model=True),
                          shape)

    def pick(self, logits, labels):
        from torch.distributed.tensor import DTensor
        if not isinstance(logits, DTensor):
            return logits.gather(-1, labels.long()[..., None])[..., 0]
        vs = self._vocab_slice(logits, logits.dim() - 1)
        il = self._local(labels, self.layout(labels), None).long()
        if vs is None:                   # a whole vocab: a local gather
            lpl = self.layout(logits)
            picked = self._local(logits, lpl, lpl).gather(
                -1, il[..., None])[..., 0]
            return self._wrap(picked, self.layout(labels),
                              tuple(labels.shape))
        lo, n = vs
        lpl = self.layout(logits, logits.dim() - 1)
        inside = (il >= lo) & (il < lo + n)
        picked = self._local(logits, lpl, lpl).gather(
            -1, torch.clamp(il - lo, 0, n - 1)[..., None])[..., 0]
        picked = picked * inside.to(picked.dtype)
        return self._wrap(picked, self.layout(labels, partial_model=True),
                          tuple(labels.shape))

    def ssd(self, fn, xh, dt, a, b, c, chunk):
        """Mamba-2's chunked scan on this rank's batch rows and heads:
        xh (B,S,H,P) and dt (B,S,H) as they come, the head decay a (H,)
        cut to the same heads; b, c (B,S,N) whole over "model"."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        if not isinstance(xh, DTensor):
            return fn(xh, dt, a, b, c, chunk)
        xpl = list(xh.placements)
        heads = [isinstance(p, Shard) and p.dim == 2 for p in xpl]
        batch = [isinstance(p, Shard) and p.dim == 0 for p in xpl]
        dpl = [Shard(2) if h else p for p, h in zip(self.layout(dt), heads)]
        apl = [Shard(0) if h else Replicate() for h in heads]
        agrad = [Shard(0) if h else Partial() if bt else Replicate()
                 for h, bt in zip(heads, batch)]
        bpl = self.layout(b)
        bgrad = [Partial() if h else p for p, h in zip(bpl, heads)]
        y, state = fn(self._local(xh, xpl, xpl), self._local(dt, dpl, dpl),
                      self._local(a, apl, agrad), self._local(b, bpl, bgrad),
                      self._local(c, bpl, bgrad), chunk)
        spl = [Shard(1) if h else p for p, h in zip(xpl, heads)]
        bsz, _, h, p = xh.shape
        return (self._wrap(y, xpl, tuple(xh.shape[:3]) + (y.shape[-1],)),
                self._wrap(state, spl, (bsz, h, p, state.shape[-1])))

    def _weights(self, weights, x):
        """Local shards of ``weights`` gathered off every axis but "model"
        (FSDP-stored ones the layer hook did not gather: the remainder
        layers), and whether any is sharded over "model". A weight's
        gradient is a Partial sum over the axes that split x's batch."""
        from torch.distributed.tensor import Replicate, Shard
        m = self.names.index("model") if "model" in self.names else -1
        wpl = [[p if i == m else Replicate() for i, p in enumerate(
            w.placements)] for w in weights]
        sharded = m >= 0 and any(isinstance(p[m], Shard) for p in wpl)
        return [self._local(w, p, self._partial_over_batch(p, x))
                for w, p in zip(weights, wpl)], wpl, sharded

    def _partial_over_batch(self, placements, x) -> list:
        """``placements`` with Partial on each mesh dim that splits x's
        batch and replicates the tensor (the gradient of a weight every
        batch shard reads)."""
        from torch.distributed.tensor import Partial, Replicate
        return [Partial() if p == Replicate() and b != Replicate() else p
                for p, b in zip(placements, self.layout(x))]

    def ffn(self, fn, x, *weights):
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return fn(x, *weights)
        wl, _, sharded = self._weights(weights, x)
        xl = self._local(x, self.layout(x),
                         self.layout(x, partial_model=sharded))
        yl = fn(xl, *wl)
        return self._wrap(yl, self.layout(x, partial_model=sharded),
                          tuple(x.shape[:-1]) + (yl.shape[-1],))

    def experts(self, fn, dispatch, combine, x, *weights):
        from torch.distributed.tensor import DTensor, Shard
        if not isinstance(x, DTensor):
            return fn(dispatch, combine, x, *weights)
        wl, wpl, sharded = self._weights(weights, x)
        m = self.names.index("model") if "model" in self.names else -1
        expert_par = sharded and isinstance(wpl[0][m], Shard) and \
            wpl[0][m].dim == 0
        epl = self.layout(dispatch, 2 if expert_par else None)
        egrad = self.layout(dispatch, 2 if expert_par else None,
                            partial_model=sharded and not expert_par)
        dl = self._local(dispatch, epl, egrad)
        cl = self._local(combine, epl, egrad)
        xl = self._local(x, self.layout(x), self.layout(
            x, partial_model=sharded))
        yl = fn(dl, cl, xl, *wl)
        return self._wrap(yl, self.layout(x, partial_model=sharded),
                          tuple(x.shape))

    def decode_experts(self, fn, x, weights, idx, *experts):
        """One token's chosen experts on this rank's experts (the other
        ranks' choices weighted 0) or expert columns; a Partial sum over
        "model" when the experts are sharded over it."""
        from torch.distributed.tensor import DTensor, Shard
        if not isinstance(x, DTensor):
            return fn(x, weights, idx, *experts)
        wl, wpl, sharded = self._weights(experts, x)
        m = self.names.index("model") if "model" in self.names else -1
        xl = self._local(x, self.layout(x), None)
        rl = self._local(weights, self.layout(weights), None)
        il = self._local(idx, self.layout(idx), None)
        if sharded and isinstance(wpl[0][m], Shard) and wpl[0][m].dim == 0:
            n = wl[0].shape[0]                   # this rank's experts
            lo = self.mesh.get_local_rank("model") * n
            rl = rl * ((il >= lo) & (il < lo + n)).to(rl.dtype)
            il = torch.clamp(il - lo, 0, n - 1)
        yl = fn(xl, rl, il, *wl)
        return self._wrap(yl, self.layout(x, partial_model=sharded),
                          tuple(x.shape))

    def dropless_experts(self, fn, x, weights, idx, *experts):
        """The dropless experts on this rank's batch shard: its sort and
        the three grouped products on its own experts or expert columns,
        a Partial sum over "model" when the experts are sharded over it.
        On this rank's experts (expert-parallel), the other ranks' choices
        take the index past its last expert, so they sort last, past the
        groups, and the products do no work on them; their weights are 0.
        The FLOPs are the products' over every local row, as the
        reference's ``hlo_cost`` counts ``ragged-dot``."""
        from torch.distributed.tensor import DTensor, Shard
        if not isinstance(x, DTensor):
            return fn(x, weights, idx, *experts)
        wl, wpl, sharded = self._weights(experts, x)
        m = self.names.index("model") if "model" in self.names else -1
        grad = self.layout(x, partial_model=sharded)
        xl = self._local(x, self.layout(x), grad)
        rl = self._local(weights, self.layout(weights),
                         self.layout(weights, partial_model=sharded))
        il = self._local(idx, self.layout(idx), None)
        if sharded and isinstance(wpl[0][m], Shard) and wpl[0][m].dim == 0:
            n = wl[0].shape[0]                   # this rank's experts
            lo = self.mesh.get_local_rank("model") * n
            inside = (il >= lo) & (il < lo + n)
            rl = rl * inside.to(rl.dtype)
            il = torch.where(inside, il - lo, torch.full_like(il, n))
        yl = fn(xl, rl, il, *wl)
        return self._wrap(yl, grad, tuple(x.shape))

    def channels(self, fn, u, prior, *weights):
        """A per-channel op on this rank's shard of u, the weights' channel
        dim (the last) cut to the same channels."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        if not isinstance(u, DTensor):
            return fn(u, prior, *weights)
        c = u.dim() - 1
        upl = list(u.placements)
        split = [isinstance(p, Shard) and p.dim == c for p in upl]
        batch = [isinstance(p, Shard) and p.dim == 0 for p in upl]
        ul = self._local(u, upl, upl)
        pl = self._local(prior, upl, upl) if isinstance(prior, DTensor) \
            else prior
        wl = []
        for w in weights:
            last = w.dim() - 1
            wpl = [Shard(last) if sp else Replicate() for sp in split]
            grad = [Shard(last) if sp else Partial() if bp else Replicate()
                    for sp, bp in zip(split, batch)]
            wl.append(self._local(w, wpl, grad))
        yl = fn(ul, pl, *wl)
        return self._wrap(yl, upl, tuple(u.shape))

    def local(self, fn, x, *args):
        """``fn`` on the local shards of x and of the tensors of ``args``
        (laid out as x); tensor results of x's rank of dims take x's
        layout, with their dims sharded as x's are; others are kept."""
        from torch.distributed.tensor import DTensor, Shard
        if not isinstance(x, DTensor):
            return fn(x, *args)
        pl = list(x.placements)
        xl = self._local(x, pl, pl)
        al = [self._local(a, pl, pl) if isinstance(a, DTensor) else a
              for a in args]

        def wrap(t):
            if not isinstance(t, torch.Tensor) or t.dim() != x.dim():
                return t
            shape = list(t.shape)
            for i, p in enumerate(pl):
                if isinstance(p, Shard):
                    shape[p.dim] *= self.mesh.size(i)
            return self._wrap(t, pl, tuple(shape))
        out = fn(xl, *al)
        return {k: wrap(v) for k, v in out.items()} if isinstance(
            out, dict) else wrap(out)

    def cache_write(self, buf, dim, slot, value):
        """The write on the local shard, in place (some DTensor builds
        register no strategy for ``index_copy_``): the value in the
        buffer's layout; along a sequence-sharded dim only the rank that
        holds the slot writes it."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(buf, DTensor):
            return buf.index_copy_(dim, slot, value)
        seq = [i for i, p in enumerate(buf.placements)
               if isinstance(p, Shard) and p.dim == dim]
        local = buf._local_tensor
        vl = self._local(value, [Replicate() if i in seq else p
                                 for i, p in enumerate(buf.placements)],
                         None) if isinstance(value, DTensor) else value
        sl = _full(slot)
        if not seq:
            local.index_copy_(dim, sl, vl)
            return buf
        n = local.shape[dim]
        lo = self._block(seq) * n
        idx = torch.clamp(sl - lo, 0, n - 1)
        inside = ((sl >= lo) & (sl < lo + n)).reshape(
            [1] * dim + [-1] + [1] * (local.dim() - dim - 1))
        local.index_copy_(dim, idx, torch.where(
            inside, vl, local.index_select(dim, idx)))
        return buf

    def _block(self, seq_dims) -> int:
        """This rank's block index along a dim sharded over the mesh dims
        ``seq_dims`` (mesh order: major first)."""
        block = 0
        for i in seq_dims:
            block = block * self.mesh.size(i) + \
                self.mesh.get_local_rank(self.names[i])
        return block

    def _flash_decode(self, q, k, v, q_pos, k_pos, window, seq_dims):
        """Attention over this rank's block of a sequence-sharded cache,
        the softmax's max, sum and output all-reduced over the blocks."""
        import torch.distributed._functional_collectives as funcol
        from repro_torch.models import attention as attn
        n = k.shape[1]
        block = self._block(seq_dims)
        k_pos = k_pos[block * n:(block + 1) * n]
        s = attn._gqa_scores(q, k) / math.sqrt(q.shape[-1])
        mask = attn._mask(q_pos, k_pos, window)
        s = torch.where(mask[None, None, None], s,
                        torch.full_like(s, attn.NEG_INF))

        def all_reduce(x, op):
            for i in seq_dims:
                x = funcol.all_reduce(x, op, (self.mesh, i))
            return x
        m = all_reduce(s.amax(dim=-1), "max")
        p = torch.exp(s - m[..., None])
        l = all_reduce(p.sum(dim=-1), "sum")
        o = all_reduce(attn._gqa_out(p, v), "sum")
        b, kv, g, sq = l.shape
        denom = l.permute(0, 3, 1, 2).reshape(b, sq, kv * g)[..., None]
        return (o / denom).to(q.dtype)


_FAKE = []


def _fake_mode():
    """The dry run's one FakeTensorMode. DTensor caches sharding results
    across calls, a vocab-parallel gather's mask buffer (a fake tensor)
    among them, so every trace of a process shares the mode that made
    it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if not _FAKE:
        _FAKE.append(FakeTensorMode(allow_non_fake_inputs=False))
    return _FAKE[0]


def _full(t):
    """A replicated DTensor's whole value (positions), a tensor as is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _nbytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = int(st.nbytes())
    return sum(seen.values())


def trace_combo(arch: str, shape_name: str, multi_pod: bool,
                moe_path: str = "gshard", remat: bool = True,
                donate: bool = True, policy=None, microbatches: int = 1,
                device: Device = None, mesh=None) -> Dict[str, Any]:
    """The row of one combination (``lower_combo``'s counterpart).
    ``mesh`` is a test seam: a ``DeviceMesh`` with "data" and "model"
    axes over a running (fake) process group, in place of the production
    mesh and its group."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_tag = "multi" if multi_pod else "single"
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                "status": "SKIP", "reason": reason}
    kw = dict(moe_path=moe_path, remat=remat, donate=donate, policy=policy,
              microbatches=microbatches, device=device)
    if mesh is not None:
        row = trace_step(cfg, shape, mesh, **kw)
    else:
        with fake_process_group(math.prod(MULTI_POD_SHAPE if multi_pod
                                          else POD_SHAPE)):
            row = trace_step(cfg, shape, make_production_mesh(
                multi_pod=multi_pod, device=device), **kw)
    row.update(arch=arch, shape=shape_name)
    return row


def trace_step(cfg, shape, mesh, *, moe_path: str = "gshard",
               remat: bool = True, donate: bool = True, policy=None,
               microbatches: int = 1, device: Device = None,
               counter: Optional[CostCounter] = None) -> Dict[str, Any]:
    """Trace one step of ``cfg`` at ``shape`` (an ``InputShape``) on
    ``mesh`` (over a running process group) and return its row;
    ``counter`` (a fresh ``CostCounter()``) is a seam that keeps the
    per-op record."""
    from torch.distributed.tensor.experimental import implicit_replication

    dev = resolve_device(device)
    policy = policy or shard.BASELINE
    chips = mesh.size()
    mesh_name = "x".join(str(s) for s in tuple(mesh.shape))
    params = tf.abstract_params(cfg)
    pspecs = shard.param_specs(params, cfg, mesh, policy)
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        optimizer = single_model(adam(1e-4))
        opt = optimizer.init(params)                      # meta
    fake = _fake_mode()
    counter = counter or CostCounter()
    counter.fake_mode = fake
    if policy.fsdp:
        tf.set_layer_param_hook(shard.make_fsdp_gather_hook(cfg, mesh))
    set_partitioner(Partitioner(mesh, policy))
    t0 = time.time()
    try:
        with fake:
            if shape.kind == "train":
                ospecs = shard.opt_specs(opt, pspecs, mesh, policy)
                bspecs = shard.batch_specs(specs, mesh, policy)
                args = (distribute(params, pspecs, mesh, dev),
                        distribute(opt, ospecs, mesh, dev),
                        distribute(specs, bspecs, mesh, dev))
                step = make_train_step(cfg, optimizer, moe_path=moe_path,
                                       remat=remat,
                                       microbatches=microbatches)
                donated = args[:2] if donate else ()
            elif shape.kind == "prefill":
                bspecs = shard.batch_specs(specs, mesh)
                args = (distribute(params, pspecs, mesh, dev),
                        distribute(specs, bspecs, mesh, dev))
                step = make_prefill_step(cfg, moe_path=moe_path,
                                         cache_seq=shape.seq_len)
                donated = ()
            else:                                           # decode
                cspecs = shard.cache_specs(specs["cache"], cfg, mesh)
                tspec = shard.batch_specs({"token": specs["token"]},
                                          mesh)["token"]
                args = (distribute(params, pspecs, mesh, dev),
                        distribute(specs["token"], tspec, mesh, dev),
                        distribute(specs["cache"], cspecs, mesh, dev))
                step = make_serve_step(cfg)
                donated = args[2:] if donate else ()
            arg_locals = _locals(args)
            counter.mark_arguments(arg_locals)
            with counter, implicit_replication():
                out = step(*args)
                if shape.kind == "train":
                    out = (place(out[0], pspecs, mesh),
                           place(out[1], ospecs, mesh), out[2])
                else:
                    out = (out[0], place(out[1], shard.cache_specs(
                        out[1], cfg, mesh), mesh))
            trace_s = time.time() - t0
            out_locals = _locals(out)
            # outputs in a donated argument's place take its buffer
            n_donated = len(_leaves(donated))
            donated_out = out_locals[:n_donated] if shape.kind == "train" \
                else out_locals[len(out_locals) - n_donated:]
            excl = counter.storage_keys(donated_out)
            out_keys = counter.storage_keys(out_locals)
            alias = sum(counter.storage_bytes(k) for k in out_keys
                        if k in excl or counter.is_argument(k))
            arg_bytes = _nbytes(arg_locals)
            out_bytes = _nbytes(out_locals)
            peak = counter.peak_bytes(exclude=excl)
    finally:
        tf.set_layer_param_hook(None)
        set_partitioner(None)
    temp = max(0, peak - (out_bytes - alias))
    mf = model_flops_estimate(cfg, shape, shape.kind)
    rl = analyze_traced(counter.cost, arch=cfg.name, shape=shape.name,
                        mesh_name=mesh_name, chips=chips, model_flops=mf,
                        bytes_per_device=float(arg_bytes + out_bytes
                                               - alias + temp))
    row = rl.row()
    row.update({
        "status": "OK",
        "trace_s": round(trace_s, 1),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "alias_bytes": alias, "temp_bytes": temp,
                   "generated_code_bytes": 0},
    })
    return row


def _combo(arch: str, shape_name: str, mp: bool, kw: dict) -> tuple:
    """One combination's (row, report lines); a failure is a FAIL row."""
    lines = []
    try:
        row = trace_combo(arch, shape_name, mp, **kw)
        if row["status"] == "OK":
            mem = row["memory"]
            lines += [
                f"  memory: args={mem['argument_bytes']/1e9:.2f}GB "
                f"temp={mem['temp_bytes']/1e9:.2f}GB "
                f"out={mem['output_bytes']/1e9:.2f}GB per device "
                f"(traced in {row['trace_s']} s)",
                f"  traced: flops={row['hlo_flops_per_dev']:.3e} "
                f"bytes={row['hlo_bytes_per_dev']:.3e} "
                f"coll={row['coll_bytes_per_dev']:.3e} per device",
                f"  roofline: compute={row['compute_s']*1e3:.2f}ms "
                f"memory={row['memory_s']*1e3:.2f}ms "
                f"collective={row['collective_s']*1e3:.2f}ms "
                f"-> {row['dominant']}-bound "
                f"(useful={row['useful_flops_frac']:.2f})"]
        else:
            lines.append(f"  SKIP: {row['reason']}")
    except Exception as e:                # a failure is a finding: report
        row = {"arch": arch, "shape": shape_name,
               "mesh": "multi" if mp else "single", "status": "FAIL",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
        lines.append(f"  FAIL: {type(e).__name__}: {e}")
    return row, lines


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--moe-path", default="gshard",
                    choices=("gshard", "dropless"))
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--dp-over-model", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--device", default=None,
                    help="device of the fake shards (default: the card)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations traced at once, each in a process "
                         "of its own (default 1: one after another, in "
                         "this process)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(INPUT_SHAPES) if (args.all or not args.shape) \
        else (args.shape,)
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    combos = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    kw = dict(moe_path=args.moe_path, remat=not args.no_remat,
              policy=shard.ShardingPolicy(dp_over_model=args.dp_over_model,
                                          fsdp=args.fsdp),
              microbatches=args.microbatches, device=args.device)

    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        pool = ProcessPoolExecutor(
            max_workers=args.jobs, max_tasks_per_child=1,
            mp_context=multiprocessing.get_context("spawn"))
        results = [pool.submit(_combo, a, s, mp, kw) for a, s, mp in combos]
    else:
        pool, results = None, None
    n = {"OK": 0, "SKIP": 0, "FAIL": 0}
    t0 = time.time()
    for i, (arch, shape_name, mp) in enumerate(combos):
        tag = f"{arch}__{shape_name}__{'multi' if mp else 'single'}"
        print(f"=== {tag} ===", flush=True)
        row, lines = results[i].result() if results \
            else _combo(arch, shape_name, mp, kw)
        print("\n".join(lines), flush=True)
        n[row["status"]] += 1
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(row, f, indent=2, default=str)
    if pool is not None:
        pool.shutdown()
    print(f"\nDRY-RUN SUMMARY: ok={n['OK']} skip={n['SKIP']} "
          f"fail={n['FAIL']} of {len(combos)} ({time.time() - t0:.1f} s)")
    if n["FAIL"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
