"""Inter-model similarity (paper Def. 4, Eq. 2).

d_nm = (1/R) sum_j KL(s^n_j || s^m_j) — asymmetric; c_nm = 1/d_nm. The
(N,N) divergence matrix is the server's O(N^2 R C) hot spot, computed by
the ``pairwise_kl`` kernel.

``update_divergence_cache`` is the incremental path: after u fresh
uploads only the row strip D[u,:] and the column strip D[:,u] change, so
a round pays O(u N R C) instead of the full rebuild. The row set is
padded to a power of two by repeating its last row (the duplicate
scatters write identical values).

``NeighborIndex`` is the sub-quadratic path: no (N,N) matrix at all. The
repository is kept in int8 wire form, clients are clustered under a
k-means coarse quantizer, and each upload pays exact rectangular KL
strips (the ``dequant_kl`` kernel) only against its probed clusters while
per-client top-L neighbor lists are maintained incrementally.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import Device, resolve_device
from repro_torch.core import wire
from repro_torch.kernels import ops
from repro_torch.sharding import (ClientMesh, device_scope, ghost_pad_stack,
                                  ghost_rows)

EPS = 1e-8


def divergence_matrix(messengers_logp: torch.Tensor,
                      mesh: Optional[ClientMesh] = None) -> torch.Tensor:
    """(N,R,C) log-messengers -> (N,N) fp32, D[n,m] = mean_j KL(n || m).

    With a client ``mesh`` of more than one entry the rebuild splits by
    rows: the repository is padded with its last row to a multiple of the
    mesh, and each entry computes its (N_pad/n_dev, N) strip with
    ``ops.pairwise_kl_pair`` on its own device against its copy of the
    whole repository. The strips meet on the repository's device and the
    pad rows are sliced off. Each row is the one-device rebuild's math;
    a GEMM over fewer rows may round differently on the card."""
    if mesh is None or mesh.size == 1:
        return ops.pairwise_kl(messengers_logp)
    n = messengers_logp.shape[0]
    padded = ghost_pad_stack(messengers_logp, ghost_rows(n, mesh.size))
    rows = padded.shape[0] // mesh.size
    home = messengers_logp.device
    strips = []
    for i, dev in enumerate(mesh.devices):
        with device_scope(dev):
            strip = ops.pairwise_kl_pair(padded[i * rows:(i + 1) * rows]
                                         .to(dev), messengers_logp.to(dev))
        strips.append(strip.to(home))
    return torch.cat(strips)[:n]


def similarity_matrix(divergence: torch.Tensor) -> torch.Tensor:
    """c_nm = 1 / d_nm with a zero diagonal (a client is never its own
    neighbor); the EPS floor keeps identical twins finite."""
    c = 1.0 / torch.clamp(divergence, min=EPS)
    return c.fill_diagonal_(0.0)


def bool_mask(mask) -> np.ndarray:
    """A host copy of an (N,) boolean mask (numpy or tensor). An integer
    0/1 array is refused: it could be a mask or an index list."""
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    mask = np.asarray(mask)
    if mask.dtype != bool:
        raise TypeError(f"uploaded must be a boolean mask, got dtype "
                        f"{mask.dtype}")
    return mask


def _bucket_rows(rows: np.ndarray) -> np.ndarray:
    """Pad the updated-row index set up to the next power of two by
    repeating the last index (a no-op for the scatter)."""
    u = len(rows)
    size = 1 << (u - 1).bit_length() if u > 1 else 1
    return np.concatenate([rows, np.full(size - u, rows[-1], rows.dtype)])


def _scatter_strips(cache: torch.Tensor, rows: torch.Tensor,
                    row_strip: torch.Tensor,
                    col_strip: torch.Tensor) -> torch.Tensor:
    """A new matrix: ``cache`` with the row strip scattered in, then the
    column strip over it (the intersections take the column strip's
    values). The old matrix is left as it was."""
    cache = cache.float().clone()
    cache[rows, :] = row_strip
    cache[:, rows] = col_strip
    return cache


def update_divergence_cache(cache: torch.Tensor,
                            messengers_logp: torch.Tensor,
                            uploaded) -> torch.Tensor:
    """Scatter the divergence strips of freshly uploaded rows into the
    cached (N,N) matrix.

    ``uploaded`` is a boolean (N,) mask of every row whose repository
    entry changed since ``cache`` was built; the others are assumed
    untouched. Returns the updated (N,N) fp32 matrix, equal to a full
    rebuild to fp32 tolerance. Two ``pairwise_kl_pair`` launches: the
    (u, N) row strip and the (N, u) column strip."""
    rows = np.nonzero(bool_mask(uploaded))[0]
    if rows.size == 0:
        return cache
    if rows.size >= messengers_logp.shape[0]:
        return divergence_matrix(messengers_logp)
    idx = torch.as_tensor(_bucket_rows(rows), device=messengers_logp.device)
    fresh = messengers_logp[idx]
    row_strip = ops.pairwise_kl_pair(fresh, messengers_logp)     # (u, N)
    col_strip = ops.pairwise_kl_pair(messengers_logp, fresh)     # (N, u)
    return _scatter_strips(cache, idx, row_strip, col_strip)


# ---------------------------------------------------------------------------
# Approximate neighbor selection: IVF-clustered top-K over the int8 wire form
# ---------------------------------------------------------------------------

_KMEANS_SAMPLE = 4096   # k-means fits on a bounded sample of active rows
_KMEANS_ITERS = 8
_ASSIGN_CHUNK = 8192    # bulk-reassign strips are bounded to (chunk, ncent)
_REFIT_GROWTH = 4       # refit the quantizer when |active| grows this factor
_PROB_FLOOR = 1e-8      # centroid probability floor before the log transform
_INF = float("inf")


def _encode_wire_rows(logp: torch.Tensor):
    """(u,R,C) fp32 log-probs -> (codes uint8, scale fp32, lse fp32).

    The int8 codec's quantization bit for bit, then lse =
    logsumexp(q·scale), so a row reconstructs as logp = q·scale − lse;
    the zero point is a per-row shift the softmax cancels, so it is
    never stored."""
    q, scale, _ = wire.quantize_int8(logp)
    scale_f = scale.float()
    lse = torch.logsumexp(q.float() * scale_f[..., None], dim=-1)
    return q, scale_f, lse


def _sorted_take(div: torch.Tensor, take: int) -> torch.Tensor:
    """Column order of each row's ``take`` smallest entries, ties to the
    lower column (``np.argsort(kind="stable")``)."""
    return torch.sort(div, dim=1, stable=True).indices[:, :take]


class NeighborIndex:
    """IVF-clustered incremental top-K neighbor index over the int8 wire
    form: the server never materializes an (N,N) divergence matrix.

    State per client, all tensors on the index's device: uint8 codes
    (R,C) with fp32 scale/lse row statistics (the wire form) and a top-L
    neighbor list (L = list_margin·k) of (id, exact divergence) pairs —
    O(N·(R·C + L)) bytes in all.

    A k-means coarse quantizer over the decoded messengers assigns every
    client to one of ~sqrt(N) clusters. On upload, the fresh rows are
    assigned, their ``n_probe`` nearest clusters are probed, and exact
    rectangular KL strips (``ops.int8_pairwise_kl_pair``) are computed
    only against the probed clusters' members: forward strips rebuild the
    uploaders' own lists, reverse strips merge the uploaders into every
    candidate's list. A merge that RAISES a stored divergence (or a
    neighbor's deactivation) can break a list's top-L property, so such
    rows are rebuilt exactly from a fresh strip in the same call; with
    ``n_probe >= n_centroids`` (probe-all) every list is exactly the top-L
    over active clients at all times. Partial probing trades that for
    sub-quadratic cost.
    """

    def __init__(self, capacity: int, ref_size: int, n_classes: int,
                 k: int, n_probe: Optional[int] = None,
                 n_centroids: Optional[int] = None,
                 list_margin: int = 2, device: Device = None,
                 seed: int = 0):
        if capacity < 1 or ref_size < 1 or n_classes < 2:
            raise ValueError(f"bad index dims: capacity={capacity}, "
                             f"ref_size={ref_size}, n_classes={n_classes}")
        if k < 1 or list_margin < 1:
            raise ValueError(f"bad list config: k={k}, "
                             f"list_margin={list_margin}")
        self.device = resolve_device(device)
        self.capacity = capacity
        self.r = ref_size
        self.c = n_classes
        self.k = k
        self.list_len = list_margin * k
        self.n_probe = n_probe          # None -> derived from ncent at fit
        self._n_centroids = n_centroids  # None -> isqrt(|active|) at fit
        self.seed = seed
        n, L, dev = capacity, self.list_len, self.device
        self._codes = torch.zeros((n, ref_size, n_classes), dtype=torch.uint8,
                                  device=dev)
        self._scale = torch.zeros((n, ref_size), dtype=torch.float32,
                                  device=dev)
        self._lse = torch.zeros((n, ref_size), dtype=torch.float32,
                                device=dev)
        self._active = torch.zeros(n, dtype=torch.bool, device=dev)
        self._assign = torch.full((n,), -1, dtype=torch.int32, device=dev)
        self._list_ids = torch.full((n, L), -1, dtype=torch.int32,
                                    device=dev)
        self._list_div = torch.full((n, L), _INF, dtype=torch.float32,
                                    device=dev)
        self._searched = torch.zeros(n, dtype=torch.bool, device=dev)
        self._centroids: Optional[torch.Tensor] = None  # (ncent,R,C) logp
        self._fit_active = 0             # |active| at the last fit
        self._fit_epoch = 0

    # -- core accessors ----------------------------------------------------
    def state_tensors(self) -> dict:
        """Every tensor the index holds, by name."""
        out = {"codes": self._codes, "scale": self._scale, "lse": self._lse,
               "active": self._active, "assign": self._assign,
               "list_ids": self._list_ids, "list_div": self._list_div,
               "searched": self._searched}
        if self._centroids is not None:
            out["centroids"] = self._centroids
        return out

    def active_rows(self) -> torch.Tensor:
        """(capacity,) bool — rows currently in the index (a copy)."""
        return self._active.clone()

    @property
    def n_centroids(self) -> int:
        return 0 if self._centroids is None else self._centroids.shape[0]

    def bytes_resident(self) -> int:
        """Device bytes held by the index (wire form + lists + quantizer),
        counted as the reference counts them."""
        return int(sum(t.numel() * t.element_size()
                       for name, t in self.state_tensors().items()
                       if name != "searched"))

    def _index(self, rows) -> torch.Tensor:
        return torch.as_tensor(rows, dtype=torch.long, device=self.device)

    def _recon_logp(self, rows: torch.Tensor) -> torch.Tensor:
        """Reconstruct (u,R,C) fp32 log-probs from the stored wire form."""
        return (self._codes[rows].float() * self._scale[rows][..., None]
                - self._lse[rows][..., None])

    # -- coarse quantizer --------------------------------------------------
    def refresh(self) -> None:
        """(Re)fit the k-means coarse quantizer on a sample of active rows
        and bulk-reassign every active row. Neighbor lists are untouched:
        they hold exact pair divergences, which a re-clustering does not
        change."""
        act = torch.nonzero(self._active).flatten()
        n_act = act.numel()
        if n_act == 0:
            self._centroids = None
            self._fit_active = 0
            return
        ncent = self._n_centroids or max(1, math.isqrt(n_act))
        ncent = min(ncent, n_act)
        # the reference's numpy draws, on the host, so the same rows are
        # picked; only the indices go to the device
        rng = np.random.default_rng([self.seed, self._fit_epoch])
        self._fit_epoch += 1
        samp = rng.choice(act.cpu().numpy(), size=min(_KMEANS_SAMPLE, n_act),
                          replace=False)
        x = torch.exp(self._recon_logp(self._index(samp))).reshape(
            samp.size, -1)
        cent = x[self._index(rng.choice(x.shape[0], size=ncent,
                                        replace=False))]
        x2 = (x * x).sum(-1)
        labels = torch.arange(ncent, device=self.device)[:, None]
        for _ in range(_KMEANS_ITERS):
            d = x2[:, None] + (cent * cent).sum(-1)[None, :] \
                - 2.0 * (x @ cent.T)
            a = d.argmin(1)
            # cluster sums as a one-hot product: a fixed summation order
            # on the card, where index_add_ would sum with atomics
            sums = (labels == a[None, :]).float() @ x
            counts = torch.bincount(a, minlength=ncent).float()
            # empty clusters keep their old centroid rather than collapsing
            cent = torch.where(counts[:, None] > 0,
                               sums / torch.clamp(counts, min=1.0)[:, None],
                               cent)
        cp = torch.clamp(cent.reshape(ncent, self.r, self.c), min=_PROB_FLOOR)
        cp = cp / cp.sum(-1, keepdim=True)
        self._centroids = torch.log(cp)
        self._fit_active = n_act
        for i in range(0, n_act, _ASSIGN_CHUNK):
            chunk = act[i:i + _ASSIGN_CHUNK]
            self._assign[chunk] = self._centroid_div(chunk).argmin(1).int()

    def _maybe_refit(self) -> None:
        n_act = int(self._active.sum())
        if (self._centroids is None
                or n_act >= _REFIT_GROWTH * max(self._fit_active, 1)):
            self.refresh()

    def _centroid_div(self, rows: torch.Tensor) -> torch.Tensor:
        """(u, ncent) exact Eq. 2 divergence row -> centroid (the
        assignment and probing metric, the lists' own metric)."""
        return ops.pairwise_kl_pair(self._recon_logp(rows), self._centroids)

    def _effective_probe(self) -> int:
        ncent = self.n_centroids
        probe = self.n_probe if self.n_probe is not None \
            else max(1, math.isqrt(ncent))
        return min(probe, ncent)

    # -- strip search ------------------------------------------------------
    def _strip(self, rows_a: torch.Tensor,
               rows_b: torch.Tensor) -> torch.Tensor:
        """Exact (|a|,|b|) KL strip straight off the stored wire form and
        the row statistics stored beside it."""
        sa, sb = self._scale[rows_a], self._scale[rows_b]
        return ops.int8_pairwise_kl_pair(
            self._codes[rows_a], sa, torch.zeros_like(sa),
            self._codes[rows_b], sb, torch.zeros_like(sb),
            lse_a=self._lse[rows_a], lse_b=self._lse[rows_b])

    def _search(self, rows: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """rows (u,) -> (candidates (m,), fwd strip (u,m)).

        Candidates are the active members of the union of each row's
        ``n_probe`` nearest clusters; the strip is exact."""
        d_cent = self._centroid_div(rows)
        self._assign[rows] = d_cent.argmin(1).int()
        probe = _sorted_take(d_cent, self._effective_probe())
        cand = torch.nonzero(self._active & torch.isin(
            self._assign, probe.unique().int())).flatten()
        if cand.numel() == 0:
            return cand, torch.zeros((rows.numel(), 0), dtype=torch.float32,
                                     device=self.device)
        return cand, self._strip(rows, cand)

    def _set_lists(self, rows: torch.Tensor, cand: torch.Tensor,
                   strip: torch.Tensor) -> None:
        """Overwrite rows' lists with the top-L of their strip columns
        (self-edges masked)."""
        L = self.list_len
        div = strip.masked_fill(cand[None, :] == rows[:, None], _INF)
        take = min(L, div.shape[1])
        order = _sorted_take(div, take)
        top_div = torch.gather(div, 1, order)
        top_ids = cand[order].int()
        if take < L:
            pad = L - take
            top_div = torch.nn.functional.pad(top_div, (0, pad), value=_INF)
            top_ids = torch.nn.functional.pad(top_ids, (0, pad), value=-1)
        self._list_ids[rows] = torch.where(torch.isfinite(top_div), top_ids,
                                           -1)
        self._list_div[rows] = top_div
        self._searched[rows] = True

    def _merge_rev(self, rows: torch.Tensor, targets: torch.Tensor,
                   rev: torch.Tensor) -> torch.Tensor:
        """Merge the uploaded ``rows`` (sorted, unique) into ``targets``'
        lists using the exact reverse strip ``rev`` (|targets|, u).
        In-place updates that RAISE a stored divergence break the top-L
        property — those targets are returned for exact rebuild."""
        L, u = self.list_len, rows.numel()
        ids_t = self._list_ids[targets]
        div_t = self._list_div[targets]
        # a list slot holds at most one uploaded row: its column in rev
        pos = torch.searchsorted(rows, ids_t.long()).clamp(max=u - 1)
        matched = rows[pos] == ids_t
        fresh = torch.where(matched, torch.gather(rev, 1, pos), div_t)
        degraded = (fresh > div_t * (1.0 + 1e-6) + 1e-12).any(dim=1)
        div_t = fresh
        # rows already updated in place must not be inserted again; a
        # target never lists itself
        listed = torch.zeros((targets.numel(), u), dtype=torch.int32,
                             device=self.device).scatter_add_(
                                 1, pos, matched.int()) > 0
        rev_m = rev.masked_fill(listed | (targets[:, None] == rows[None, :]),
                                _INF)
        comb_div = torch.cat([div_t, rev_m], dim=1)
        comb_ids = torch.cat([ids_t, rows[None, :].expand(targets.numel(), u)
                              .int()], dim=1)
        order = _sorted_take(comb_div, L)
        new_div = torch.gather(comb_div, 1, order)
        new_ids = torch.gather(comb_ids, 1, order)
        self._list_ids[targets] = torch.where(torch.isfinite(new_div),
                                              new_ids, -1)
        self._list_div[targets] = new_div
        return targets[degraded]

    def _rebuild(self, rows: torch.Tensor) -> None:
        """Exact list rebuild of ``rows``, in bounded chunks."""
        for i in range(0, rows.numel(), _ASSIGN_CHUNK):
            chunk = rows[i:i + _ASSIGN_CHUNK]
            cand, fwd = self._search(chunk)
            self._set_lists(chunk, cand, fwd)

    # -- public mutation API ----------------------------------------------
    def ingest_only(self, rows, logp) -> None:
        """Store rows' wire forms and activate them WITHOUT maintaining
        any neighbor list — the bulk-build path. Follow with
        ``refresh()``; lists materialize as rows pass through ``update``."""
        rows = self._index(rows)
        q, s, lse = _encode_wire_rows(
            torch.as_tensor(logp).to(self.device, torch.float32))
        self._codes[rows] = q
        self._scale[rows] = s
        self._lse[rows] = lse
        self._active[rows] = True

    def update(self, rows, logp) -> int:
        """Ingest freshly uploaded rows and repair the neighbor lists:
        rebuild the uploaders' own lists from forward strips, merge them
        into every candidate's list from reverse strips, and exactly
        rebuild any list the merge degraded. Returns the number of
        degraded rows rebuilt (diagnostic)."""
        if isinstance(rows, torch.Tensor):
            rows = rows.cpu().numpy()
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return 0
        # dedup (last write wins), payload aligned with the sorted ids
        rows_u, first = np.unique(rows[::-1], return_index=True)
        if rows_u.max() >= self.capacity or rows_u.min() < 0:
            raise ValueError(f"row ids out of range [0, {self.capacity}): "
                             f"{rows_u.min()}..{rows_u.max()}")
        logp = torch.as_tensor(logp)
        logp = logp[torch.as_tensor(rows.size - 1 - first,
                                    device=logp.device)]
        rows = self._index(rows_u)
        self.ingest_only(rows, logp)
        self._maybe_refit()
        cand, fwd = self._search(rows)
        self._set_lists(rows, cand, fwd)
        targets = cand[~torch.isin(cand, rows)]
        if targets.numel() == 0:
            return 0
        rev = self._strip(targets, rows)
        degraded = self._merge_rev(rows, targets, rev)
        self._rebuild(degraded)
        return int(degraded.numel())

    def sync_active(self, active) -> None:
        """Fold the server's (capacity,) active mask into the index.
        Deactivated clients are dropped from the population and every
        list that referenced one is rebuilt exactly (a shrunk list may
        have lost top-L members to the filter)."""
        active = torch.as_tensor(active).to(self.device, torch.bool)
        if tuple(active.shape) != (self.capacity,):
            raise ValueError(f"active mask shape {tuple(active.shape)} != "
                             f"({self.capacity},)")
        dropped = torch.nonzero(self._active & ~active).flatten()
        self._active &= active
        if dropped.numel() == 0 or self._centroids is None:
            return
        hit = torch.isin(self._list_ids, dropped.int()).any(dim=1) \
            & self._active
        self._rebuild(torch.nonzero(hit).flatten())

    # -- selection ---------------------------------------------------------
    def select(self, cand_mask, k: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-client top-k neighbors among the candidate pool.

        cand_mask (capacity,) bool — the quality pool Q. Returns
        (neighbors (capacity,k) int32 with -1 padding, divergence
        (capacity,k) fp32 with +inf padding). A client never selects
        itself, a never-ingested row, an inactive client, or a
        non-candidate."""
        k = self.k if k is None else k
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        cand = torch.as_tensor(cand_mask).to(self.device, torch.bool)
        if tuple(cand.shape) != (self.capacity,):
            raise ValueError(f"candidate mask shape {tuple(cand.shape)} != "
                             f"({self.capacity},)")
        ids = self._list_ids
        safe = ids.clamp(min=0).long()
        rows_all = torch.arange(self.capacity, device=self.device)
        valid = ((ids >= 0) & self._active[safe] & cand[safe]
                 & (ids != rows_all[:, None]))
        div = torch.where(valid, self._list_div, _INF)
        k = min(k, self.list_len)
        order = _sorted_take(div, k)
        top_div = torch.gather(div, 1, order)
        top_ids = torch.where(torch.isfinite(top_div),
                              torch.gather(ids, 1, order), -1)
        # repair pass: a top-L list filtered by a SMALL candidate pool can
        # keep fewer than k entries though better candidates exist outside
        # the list. Those rows get an exact strip search against the pool;
        # rows that never had a list built (ingest_only) stay empty.
        ok = cand & self._active
        pool = torch.nonzero(ok).flatten()
        if pool.numel():
            reach = pool.numel() - ok.long()
            have = (top_ids >= 0).sum(dim=1)
            deficient = torch.nonzero(
                self._active & self._searched
                & (have < torch.clamp(reach, max=k))).flatten()
            for i in range(0, deficient.numel(), _ASSIGN_CHUNK):
                rows = deficient[i:i + _ASSIGN_CHUNK]
                strip = self._strip(rows, pool).masked_fill(
                    pool[None, :] == rows[:, None], _INF)
                take = min(k, strip.shape[1])
                o = _sorted_take(strip, take)
                d = torch.gather(strip, 1, o)
                top_ids[rows] = -1
                top_div[rows] = _INF
                top_ids[rows, :take] = torch.where(torch.isfinite(d),
                                                   pool[o].int(), -1)
                top_div[rows, :take] = d
        return top_ids, top_div
