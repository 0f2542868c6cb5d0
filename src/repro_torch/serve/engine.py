"""Batched personalized inference: gather-from-stack + pow2 bucketing.

A request batch is ``(client_ids, features)``; each client must be
answered by its own personalized params. Instead of one forward per
client, the serve step gathers the requested rows out of the cohort's
stacked params (a snapshot's copies) and runs the cohort's own module on
them with ``torch.func.functional_call``: one stacked forward over the
whole batch, the same discipline the training cohorts use (``bmm`` over
rows for an MLP tier, ``torch.func.vmap`` for a zoo family).

Batch sizes are padded up to power-of-two buckets (``bucket_size``), so
a bursty workload runs a handful of shapes, not one per batch size.

Responses carry the snapshot ``version`` and ``staleness`` (virtual age
of the params at serve time), so every answer states how old the model
that produced it is.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.serve.snapshot import (CohortView, Params, Snapshot,
                                        SnapshotStore)


def bucket_size(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


@torch.no_grad()
def serve_step(module: nn.Module, params: Params, rows: torch.Tensor,
               xs: torch.Tensor) -> torch.Tensor:
    """Gather the requested rows from the stacked params and answer every
    request with its own client's model: rows (B,), xs (B, ...) ->
    logits (B, C).

    Each request runs as a two-sample input (its features plus one zero
    ghost sample, sliced off), the reference's serving shape: a one-row
    forward can take another GEMM path than the evaluation's."""
    gathered = {k: v.index_select(0, rows) for k, v in params.items()}
    pair = torch.stack([xs, torch.zeros_like(xs)], dim=1)
    return torch.func.functional_call(module, gathered, (pair,))[:, 0]


@dataclasses.dataclass
class ServeResult:
    """One served request batch (already sliced back to the real B)."""
    client_ids: np.ndarray       # (B,)
    logits: np.ndarray           # (B, C)
    preds: np.ndarray            # (B,)
    version: int                 # snapshot version that answered
    published_at: float          # its virtual publish time
    staleness: float             # serve_time - published_at
    buckets: Tuple[int, ...]     # pow2 bucket per cohort sub-batch
    compute_s: float             # wall seconds of the forwards, to the
    # logits' copy to the host

    @property
    def n(self) -> int:
        return len(self.client_ids)


class QueryEngine:
    """Serves request batches from the store's current snapshot.

    One ``serve`` call splits the batch by cohort (clients of different
    families live in different stacks), pads each sub-batch to its
    power-of-two bucket, and runs one gather-forward per cohort.
    ``bucket_floor`` raises the smallest bucket; ``max_bucket`` caps the
    bucket, and bigger sub-batches split into ``max_bucket`` chunks."""

    def __init__(self, store: SnapshotStore, bucket_floor: int = 1,
                 max_bucket: int = 128):
        if bucket_floor < 1:
            raise ValueError(f"bucket_floor must be >= 1, got "
                             f"{bucket_floor}")
        if max_bucket < bucket_floor:
            raise ValueError(f"max_bucket ({max_bucket}) must be >= "
                             f"bucket_floor ({bucket_floor})")
        self.store = store
        self.bucket_floor = int(bucket_floor)
        self.max_bucket = int(max_bucket)

    def _forward(self, view: CohortView, rows: np.ndarray, xs: np.ndarray
                 ) -> Tuple[torch.Tensor, int]:
        """One bucketed gather-forward against a cohort view."""
        b = len(rows)
        bucket = min(bucket_size(b, self.bucket_floor), self.max_bucket)
        pad = bucket - b
        # padded rows re-serve row 0 (always real: n_real >= 1) and are
        # sliced off below — they cost FLOPs, never correctness
        rows_p = np.concatenate([rows, np.zeros(pad, rows.dtype)]) if pad \
            else rows
        xs_p = np.concatenate([xs, np.zeros((pad,) + xs.shape[1:],
                                            xs.dtype)]) if pad else xs
        dev = next(iter(view.params.values())).device
        out = serve_step(view.module, view.params,
                         torch.as_tensor(rows_p, device=dev),
                         torch.as_tensor(xs_p, dtype=torch.float32,
                                         device=dev))
        return out[:b], bucket

    def serve(self, client_ids: Sequence[int], xs: np.ndarray,
              t: float, snapshot: Optional[Snapshot] = None) -> ServeResult:
        """Answer ``(client_ids[i], xs[i])`` for every i from one
        consistent snapshot (default: the store's current)."""
        snap = snapshot if snapshot is not None else self.store.current()
        cids = np.asarray(client_ids, np.int64)
        if cids.ndim != 1 or len(cids) != len(xs):
            raise ValueError(f"client_ids {cids.shape} and features "
                             f"{np.shape(xs)} disagree on batch size")
        if cids.size and (cids.min() < 0 or cids.max() >= snap.n_clients):
            raise ValueError(f"client id out of range [0, "
                             f"{snap.n_clients}): {cids.tolist()}")
        xs = np.asarray(xs)
        logits: Optional[np.ndarray] = None
        buckets: List[int] = []
        compute = 0.0
        for vi in np.unique(snap.view_of[cids]):
            sel = np.where(snap.view_of[cids] == vi)[0]
            view = snap.views[int(vi)]
            rows = snap.row_of[cids[sel]]
            xs_sel = xs[sel]
            t0 = time.perf_counter()
            chunks = []
            for lo in range(0, len(sel), self.max_bucket):
                hi = lo + self.max_bucket
                out, bucket = self._forward(view, rows[lo:hi],
                                            xs_sel[lo:hi])
                chunks.append(out)
                buckets.append(bucket)
            part = torch.cat(chunks).cpu().numpy()     # synchronizes
            compute += time.perf_counter() - t0
            if logits is None:
                logits = np.zeros((len(cids), part.shape[-1]), part.dtype)
            logits[sel] = part
        if logits is None:
            logits = np.zeros((0, 0), np.float32)
        return ServeResult(
            client_ids=cids, logits=logits,
            preds=np.argmax(logits, -1) if len(cids) else
            np.zeros(0, np.int64),
            version=snap.version, published_at=snap.published_at,
            staleness=snap.staleness(t), buckets=tuple(buckets),
            compute_s=compute)
