"""Public entry points of the server kernels, dispatched by the device of
the tensors they are given.

A CPU tensor goes to the plain PyTorch version; a CUDA tensor goes to
the hand-written CUDA kernel, or the call raises. There is no setting
that puts the plain version on the card: the reference's
``REPRO_KERNEL_BACKEND`` switch has no counterpart here.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import dequant_kl as _dk
from repro_torch.kernels import neighbor_gather as _ng
from repro_torch.kernels import neighbor_mean as _nm
from repro_torch.kernels import pairwise_kl as _pk
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
             "int8_pairwise_kl_pair": (_dk, "launches")}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel (plain-version calls not counted)."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
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
    uint8, scale/zp (N,R) (``wire.Int8`` payload fields) -> (N,N) fp32.
    N > CHUNK_ROWS is computed as CHUNK_ROWS x N row strips."""
    q, scale, zp = q.contiguous(), scale.contiguous(), zp.contiguous()
    n = q.shape[0]
    if n > CHUNK_ROWS:
        return torch.cat([
            int8_pairwise_kl_pair(q[i:i + CHUNK_ROWS],
                                  scale[i:i + CHUNK_ROWS],
                                  zp[i:i + CHUNK_ROWS], q, scale, zp)
            for i in range(0, n, CHUNK_ROWS)], dim=0)
    return int8_pairwise_kl_pair(q, scale, zp, q, scale, zp)


def int8_pairwise_kl_pair(qa: torch.Tensor, sa: torch.Tensor,
                          zpa: torch.Tensor, qb: torch.Tensor,
                          sb: torch.Tensor,
                          zpb: torch.Tensor) -> torch.Tensor:
    """Rectangular Eq. 2 strip between two int8 wire forms: qa (U,R,C) /
    qb (M,R,C) uint8 with per-row scale/zp -> (U,M) fp32. The IVF index's
    search primitive."""
    return _dk.int8_pairwise_kl_pair(
        qa.contiguous(), sa.contiguous(), zpa.contiguous(),
        qb.contiguous(), sb.contiguous(), zpb.contiguous())


def soft_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Eq. 1 quality scores. logits (N,R,C), labels (R,) -> (N,) fp32."""
    return _sc.soft_ce(logits.contiguous(),
                       labels.to(torch.int32).contiguous())


def neighbor_mean(w: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Eq. 5 targets on a dense W (FedMD's complete graph). w (N,N),
    probs (N,R,C) -> (N,R,C) fp32."""
    return _nm.neighbor_mean(w.float().contiguous(), probs.contiguous())


def neighbor_gather(nbrs: torch.Tensor, w: torch.Tensor,
                    probs: torch.Tensor) -> torch.Tensor:
    """Eq. 5 targets over the neighbor lists of a sparse graph: nbrs (N,K)
    indices, w (N,K) slot weights, probs (N,R,C) -> (N,R,C) fp32."""
    return _ng.neighbor_gather(nbrs.to(torch.int32).contiguous(),
                               w.float().contiguous(), probs.contiguous())
