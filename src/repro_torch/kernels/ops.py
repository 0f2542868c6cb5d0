"""Public entry points of the hand kernels, dispatched by the device of
the tensors they are given.

A CPU tensor goes to the plain PyTorch version; a CUDA tensor goes to
the hand-written CUDA kernel, or the call raises. There is no setting
that puts the plain version on the card: the reference's
``REPRO_KERNEL_BACKEND`` switch has no counterpart here.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import dequant_kl as _dk
from repro_torch.kernels import neighbor_gather as _ng
from repro_torch.kernels import neighbor_mean as _nm
from repro_torch.kernels import pairwise_kl as _pk
from repro_torch.kernels import ragged_dot as _rd
from repro_torch.kernels import soft_ce as _sc

# Above this many rows the square divergence rebuild streams row-block
# strips instead of one call, bounding each call's output and scratch.
CHUNK_ROWS = 2048

# each kernel's launch counter: (wrapper module, attribute)
_COUNTERS = {"pairwise_kl_split": (_pk, "split_launches"),
             "pairwise_kl_pair": (_pk, "launches"),
             "soft_ce": (_sc, "launches"),
             "neighbor_gather": (_ng, "launches"),
             "neighbor_mean": (_nm, "launches"),
             "neighbor_mean_split": (_nm, "split_launches"),
             "int8_pairwise_kl_split": (_dk, "split_launches"),
             "int8_pairwise_kl_thin": (_dk, "thin_launches"),
             "int8_pairwise_kl_pair": (_dk, "launches"),
             "ragged_dot": (_rd, "launches"),
             "ragged_dot_wgrad": (_rd, "wgrad_launches")}


# launches of the Hopper routes of the kernels that have several, by the
# shape they were given (the calls already counted in that kernel's total
# above): bf16's (tma), fp32's products (tf32) and the splits before them
_ROUTE_COUNTERS = {"ragged_dot.tma": (_rd, "tma_launches"),
                   "ragged_dot_wgrad.tma": (_rd, "tma_wgrad_launches"),
                   "ragged_dot.tf32": (_rd, "tf32_launches"),
                   "ragged_dot_wgrad.tf32": (_rd, "tf32_wgrad_launches"),
                   "ragged_dot.tf32_split": (_rd, "tf32_split_launches"),
                   "ragged_dot_wgrad.tf32_split": (
                       _rd, "tf32_wgrad_split_launches")}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel (plain-version calls not counted)."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTERS.items()}


def route_counts() -> Dict[str, int]:
    """Launches so far of the Hopper routes of ``ragged_dot`` and
    ``ragged_dot_wgrad``: bf16's, and fp32's products and splits (the
    rest of their totals took the first route)."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _ROUTE_COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in (*_COUNTERS.values(), *_ROUTE_COUNTERS.values()):
        setattr(mod, attr, 0)


def pairwise_kl(logp: torch.Tensor) -> torch.Tensor:
    """Eq. 2 divergence matrix, logp (N,R,C) -> (N,N) fp32, computed as
    independent CHUNK_ROWS x N row strips, concatenated; on the card the
    repository is split once for all strips."""
    return _pk.pairwise_kl(logp.contiguous(), CHUNK_ROWS)


def pairwise_kl_pair(logp_a: torch.Tensor,
                     logp_b: torch.Tensor) -> torch.Tensor:
    """Rectangular Eq. 2 strip: logp_a (U,R,C), logp_b (M,R,C) -> (U,M)."""
    return _pk.pairwise_kl_pair(logp_a.contiguous(), logp_b.contiguous())


def int8_pairwise_kl(q: torch.Tensor, scale: torch.Tensor,
                     zp: torch.Tensor) -> torch.Tensor:
    """Eq. 2 divergence matrix straight off the int8 wire form: q (N,R,C)
    uint8, scale/zp (N,R) (``wire.Int8`` payload fields) -> (N,N) fp32,
    computed as CHUNK_ROWS x N row strips; on the card the repository is
    split once for all strips."""
    return _dk.int8_pairwise_kl(q.contiguous(), scale.contiguous(),
                                zp.contiguous(), CHUNK_ROWS)


def int8_pairwise_kl_pair(qa: torch.Tensor, sa: torch.Tensor,
                          zpa: torch.Tensor, qb: torch.Tensor,
                          sb: torch.Tensor, zpb: torch.Tensor,
                          lse_a: Optional[torch.Tensor] = None,
                          lse_b: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Rectangular Eq. 2 strip between two int8 wire forms: qa (U,R,C) /
    qb (M,R,C) uint8 with per-row scale/zp -> (U,M) fp32. The IVF index's
    search primitive; it passes the row statistics it stores as
    ``lse_a``/``lse_b`` (fp32 (U,R) / (M,R)), else they are computed."""
    return _dk.int8_pairwise_kl_pair(
        qa.contiguous(), sa.contiguous(), zpa.contiguous(),
        qb.contiguous(), sb.contiguous(), zpb.contiguous(),
        lse_a=None if lse_a is None else lse_a.contiguous(),
        lse_b=None if lse_b is None else lse_b.contiguous())


def soft_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Eq. 1 quality scores. logits (N,R,C), labels (R,) -> (N,) fp32."""
    return _sc.soft_ce(logits.contiguous(),
                       labels.to(torch.int32).contiguous())


def neighbor_mean(w: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Eq. 5 targets on a dense W (FedMD's complete graph). w (N,N),
    probs (N,R,C) -> (N,R,C) fp32; on the card two splits and B1's 3xTF32
    GEMM."""
    return _nm.neighbor_mean(w.float().contiguous(), probs.contiguous())


def neighbor_gather(nbrs: torch.Tensor, w: torch.Tensor,
                    probs: torch.Tensor) -> torch.Tensor:
    """Eq. 5 targets over the neighbor lists of a sparse graph: nbrs (N,K)
    indices, w (N,K) slot weights, probs (N,R,C) -> (N,R,C) fp32."""
    return _ng.neighbor_gather(nbrs.to(torch.int32).contiguous(),
                               w.float().contiguous(), probs.contiguous())


def ragged_dot(lhs: torch.Tensor, rhs: torch.Tensor,
               group_sizes: torch.Tensor,
               transpose_rhs: bool = False) -> torch.Tensor:
    """``jax.lax.ragged_dot``, the dropless MoE's grouped product: lhs
    (M,K) with its rows sorted by group, rhs (G,K,N) (``transpose_rhs``:
    (G,N,K), read transposed), group_sizes (G,) int32 -> (M,N) in lhs's
    dtype, rows at or past sum(group_sizes) 0; differentiable in lhs and
    rhs, with no host sync on the card."""
    return _rd.ragged_dot(lhs.contiguous(), rhs.contiguous(),
                          group_sizes.contiguous(), bool(transpose_rhs))


def ragged_dot_wgrad(lhs: torch.Tensor, grad: torch.Tensor,
                     group_sizes: torch.Tensor) -> torch.Tensor:
    """The weight gradient of ``ragged_dot``: lhs (M,K), grad (M,N) ->
    (G,K,N), each group's lhs rows transposed times its grad rows."""
    return _rd.ragged_dot_wgrad(lhs.contiguous(), grad.contiguous(),
                                group_sizes.contiguous())
