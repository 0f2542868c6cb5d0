"""Client-side state and the stacked cohort step (Algorithm 1 line 12).

Clients of one architecture form a *cohort*: one module (a ``CohortMLP``
or a zoo family's ``StackedCohort``) whose params stack the clients on a
leading axis, trained by the family's own optimizer. A step runs one
forward for the whole cohort and one backward of the summed per-client
losses — clients share no parameter and no norm or attention spans the
client axis, so each gets exactly its own gradient (the counterpart of
the reference's ``vmap(value_and_grad)``). Params are updated in place.
A cohort is one or more shards of its rows (``repro_torch.sharding``);
``sharded_cohort_step`` and ``sharded_messenger_upload`` run every shard
on its own device; on the card the step is replayed as a CUDA graph.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from repro_torch import trace
from repro_torch.core import wire
from repro_torch.core.distill import sqmd_loss
from repro_torch.core.messenger import cohort_messengers
from repro_torch.data.pipeline import cohort_batch_padded
from repro_torch.optim import Optimizer, state_tensors
from repro_torch.sharding import ClientMesh, CohortShard, map_tensors

# a stacked forward: a cohort module, or a Cohort's ``real_forward``
Forward = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class Cohort:
    """All clients sharing one model family, as one or more shards.

    Unsharded, the cohort is one ``CohortShard`` holding every client.
    Placed on a client mesh (``repro_torch.sharding.place_cohort_stacks``)
    its stacks carry ``n_pad`` extra GHOST rows, copies of the last real
    client that the step's trainable mask keeps frozen, and are split into
    one shard a mesh entry. ``client_ids`` lists the REAL clients only."""
    family_name: str
    shards: List[CohortShard]
    client_ids: np.ndarray               # (n_c,) global client indices
    optimizer: Optimizer                 # the family's optimizer
    n_pad: int = 0                       # ghost rows (mesh-multiple pad)
    mesh: Optional[ClientMesh] = None    # the mesh the shards live on

    @classmethod
    def whole(cls, family_name: str, model: nn.Module, opt_state,
              client_ids, data: Dict[str, torch.Tensor],
              optimizer: Optimizer) -> "Cohort":
        """An unsharded cohort: one shard of every client."""
        return cls(family_name, [CohortShard(model, opt_state, data)],
                   np.asarray(client_ids), optimizer)

    @property
    def n_clients(self) -> int:
        return len(self.client_ids)

    @property
    def n_rows(self) -> int:
        """Stacked rows, ghost padding included."""
        return self.n_clients + self.n_pad

    @property
    def padded_ids(self) -> np.ndarray:
        """Global client index per stacked row; ghost rows alias the last
        real client (their targets and availability gather somewhere
        valid; the trainable mask is what silences them)."""
        if self.n_pad == 0:
            return self.client_ids
        return np.concatenate(
            [self.client_ids,
             np.full(self.n_pad, self.client_ids[-1],
                     self.client_ids.dtype)])

    def real_rows(self, shard: CohortShard) -> int:
        """How many of ``shard``'s rows are real clients."""
        return max(0, min(shard.n_rows, self.n_clients - shard.start))

    def _single(self) -> CohortShard:
        if len(self.shards) != 1:
            raise ValueError(
                f"cohort {self.family_name!r} is split into "
                f"{len(self.shards)} shards: read .shards, .real_params, "
                f".real_opt_state or .real_forward")
        return self.shards[0]

    @property
    def model(self) -> nn.Module:
        """The stacked module of an unsharded cohort."""
        return self._single().model

    @property
    def opt_state(self):
        return self._single().opt_state

    @opt_state.setter
    def opt_state(self, value) -> None:
        self._single().opt_state = value

    @property
    def data(self) -> Dict[str, torch.Tensor]:
        return self._single().data

    @property
    def module(self) -> nn.Module:
        """A module of the cohort's architecture (its first shard's), for
        parameter names and layout, never for rows."""
        return self.shards[0].model

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def _real(self, per_shard) -> list:
        """Each shard's real rows of ``per_shard(shard)`` (a list of
        tensors), concatenated on the first shard's device."""
        if self.n_pad == 0 and len(self.shards) == 1:
            return per_shard(self.shards[0])
        blocks = [[t[:self.real_rows(sh)].to(self.device)
                   for t in per_shard(sh)]
                  for sh in self.shards if self.real_rows(sh)]
        return [torch.cat(ts) for ts in zip(*blocks)]

    @property
    def real_params(self) -> Dict[str, torch.Tensor]:
        """The real clients' params by name, ghost rows sliced off, on
        the first shard's device (an unsharded cohort's own tensors)."""
        names = [k for k, _ in self.module.named_parameters()]
        return dict(zip(names, self._real(
            lambda sh: [p.detach() for p in sh.model.parameters()])))

    @property
    def real_opt_state(self):
        """The real clients' optimizer state, on the first shard's
        device."""
        first = self.shards[0].opt_state
        leaves = self._real(lambda sh: state_tensors(sh.opt_state))
        it = iter(leaves)
        return map_tensors(lambda _: next(it), first)

    def real_forward(self, xs: torch.Tensor) -> torch.Tensor:
        """Logits (n_c, M, C) of the real clients on their stacked inputs
        xs (n_c, M, ...), computed on ``xs``'s device."""
        if len(self.shards) == 1 and self.n_pad == 0:
            return self.shards[0].model(xs)
        params = {k: t.to(xs.device) for k, t in self.real_params.items()}
        return torch.func.functional_call(self.module, params, (xs,))


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _gate(on: torch.Tensor, old, new):
    """``new`` on the rows of ``on``, ``old`` elsewhere, for a tensor, a
    list of tensors, or None."""
    if new is None:
        return None
    if isinstance(new, torch.Tensor):
        return torch.where(_rows(on, new), new, old)
    return [_gate(on, a, b) for a, b in zip(old, new)]


def cohort_step(model: nn.Module, optimizer: Optimizer,
                opt_state, batch_x: torch.Tensor,
                batch_y: torch.Tensor, ref_x: torch.Tensor,
                targets: torch.Tensor, trainable: torch.Tensor,
                rho: float, use_ref: bool, cohort: Optional[str] = None):
    """One optimizer step for a whole cohort, in place on ``model``.

    batch_x (n_c,B,L), batch_y (n_c,B), targets (n_c,R,C) per-client
    distill targets, trainable (n_c,) bool. Rows outside ``trainable``
    keep their params AND every optimizer-state leaf, the per-client step
    counter included, bit for bit. ``cohort`` names the family on the
    step's spans. Returns (opt_state, per-client loss)."""
    params = list(model.parameters())
    with torch.enable_grad():
        with trace.span("client.forward", cohort=cohort):
            loss = sqmd_loss(model, batch_x, batch_y, ref_x, targets, rho,
                             use_ref)
        with trace.span("client.backward", cohort=cohort):
            grads = torch.autograd.grad(loss.sum(), params)
    with trace.span("client.optimizer", cohort=cohort):
        with torch.no_grad():
            updates, new_state = optimizer.update(
                grads, opt_state, [p.detach() for p in params])
            on = trainable.to(torch.bool)
            for p, u in zip(params, updates):
                p.copy_(torch.where(_rows(on, p), p + u.to(p.dtype), p))
        # every leaf of the state is gated, the step counter included: a
        # woken client resumes with its own Adam bias correction
        state = type(new_state)(*(_gate(on, a, b)
                                  for a, b in zip(opt_state, new_state)))
    return state, loss.detach()


def cohort_messenger_upload(model: nn.Module, ref_x: torch.Tensor,
                            codec: Union[None, str, wire.Codec] = None):
    """(n_c, R, C) log-prob messengers, wire-encoded when ``codec`` is
    given."""
    return cohort_messengers(model, ref_x, codec=codec)


def _shard_step(sh: CohortShard, optimizer: Optimizer, rho: float,
                use_ref: bool, cohort: str, inputs, state):
    """``cohort_step`` of shard ``sh`` from ``state`` on the call's inputs
    on its device (its real rows' batch indices, ref_x, its targets and
    trainable rows), the batch gather included; the new state."""
    real, ref_x, targets, trainable = inputs
    with trace.span("client.batch", cohort=cohort):
        batch = cohort_batch_padded(sh.data, real)
    state, _ = cohort_step(sh.model, optimizer, state, batch["x"],
                           batch["y"], ref_x, targets, trainable, rho,
                           use_ref, cohort=cohort)
    return state


def sharded_cohort_step(cohort: Cohort, idx: torch.Tensor,
                        ref_x: torch.Tensor, targets: torch.Tensor,
                        trainable: torch.Tensor, rho: float,
                        use_ref: bool) -> None:
    """One optimizer step of every shard of ``cohort``, each on its own
    device, in place.

    idx (n_c, B) batch indices drawn at the REAL cohort size; targets
    (n_rows, R, C) and trainable (n_rows,) over the padded rows (ghost
    rows must be False). A shard's ghost rows take the last real
    client's indices (``cohort_batch_padded``), so its gather stays
    inside its own rows. On the card a shard's step is captured as one
    CUDA graph on its second call with the same shapes, storage, ``rho``
    and ``use_ref``, and replayed from then on (``repro_torch.step_graph``:
    its optimizer state is then updated in place); off the card it is
    ``cohort_step``."""
    name = cohort.family_name
    for sh in cohort.shards:
        lo, hi = sh.start, sh.start + sh.n_rows
        dev = sh.device
        # the shard's real rows' indices (the last real client's for a
        # shard of ghosts only), edge-replicated over its ghosts
        inputs = (idx[min(lo, cohort.n_clients - 1):hi], ref_x,
                  targets[lo:hi], trainable[lo:hi])
        step = functools.partial(_shard_step, sh, cohort.optimizer, rho,
                                 use_ref, name)
        if dev.type == "cuda":
            sh.opt_state = sh.graphs.step(
                step, inputs, sh.opt_state,
                fixed=[*sh.model.parameters(), *sh.model.buffers(),
                       *sh.data.values()],
                static=(rho, use_ref, cohort.optimizer), device=dev,
                cohort=name)
        else:
            sh.opt_state = step([t.to(dev) for t in inputs], sh.opt_state)


def sharded_messenger_upload(cohort: Cohort, ref_x: torch.Tensor,
                             codec: Union[str, wire.Codec],
                             device: torch.device):
    """Every shard's wire-encoded messengers, each computed and encoded
    on its shard's device, ghost rows sliced off, moved to ``device``.
    Returns (payloads, their global client ids); a shard of ghosts only
    uploads nothing."""
    parts, rows = [], []
    for sh in cohort.shards:
        real = cohort.real_rows(sh)
        if real == 0:
            continue
        part = cohort_messenger_upload(sh.model, ref_x.to(sh.device),
                                       codec=codec)
        if real < sh.n_rows:
            part = wire.gather(part, np.arange(real))
        parts.append(wire.Payload(
            part.codec, part.domain, part.shape,
            {k: a.to(device) for k, a in part.arrays.items()}))
        rows.append(cohort.client_ids[sh.start:sh.start + real])
    return parts, rows


@torch.no_grad()
def cohort_accuracy(model: Forward, xs: torch.Tensor,
                    ys: torch.Tensor) -> torch.Tensor:
    """Per-client accuracy on stacked eval shards (n_c, M, L)/(n_c, M).
    ``model`` is a cohort module or a ``Cohort.real_forward``."""
    pred = torch.argmax(model(xs), dim=-1)
    return (pred == ys).float().mean(dim=-1)


@torch.no_grad()
def cohort_accuracy_masked(model: Forward, xs: torch.Tensor,
                           ys: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Per-client accuracy over unequal shard lengths: shards padded to
    the cohort max, ``mask (n_c, M)`` marking the real samples."""
    hit = (torch.argmax(model(xs), dim=-1) == ys) & mask
    return hit.sum(dim=-1) / torch.clamp(mask.sum(dim=-1), min=1).float()


@torch.no_grad()
def cohort_pred(model: Forward, xs: torch.Tensor) -> torch.Tensor:
    return torch.argmax(model(xs), dim=-1)
