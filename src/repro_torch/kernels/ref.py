"""Plain PyTorch versions of the server kernels (the CPU path, and the
yardstick the CUDA kernels are held against on the card).

Conventions as in the reference: messengers are LOG-probabilities
``logp (N, R, C)``; every reduction runs in fp32 whatever the input type.
"""
from __future__ import annotations

import torch


def pairwise_kl_ref(logp: torch.Tensor) -> torch.Tensor:
    """Eq. 2: D[n,m] = (1/R) sum_j KL(s^n_j || s^m_j), logp (N,R,C) -> (N,N).

    KL(p_n || p_m) = rowterm(n) - <p_n, logp_m>, rowterm = sum p_n logp_n."""
    return pairwise_kl_pair_ref(logp, logp)


def pairwise_kl_pair_ref(logp_a: torch.Tensor,
                         logp_b: torch.Tensor) -> torch.Tensor:
    """Rectangular Eq. 2 strip: logp_a (U,R,C), logp_b (M,R,C) -> (U,M)."""
    u, r, c = logp_a.shape
    la = logp_a.float().reshape(u, r * c)
    lb = logp_b.float().reshape(logp_b.shape[0], r * c)
    pa = torch.exp(la)
    rowterm = torch.sum(pa * la, dim=-1)                    # (U,)
    cross = pa @ lb.T                                       # (U,M)
    return (rowterm[:, None] - cross) / r


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero as ``cvt.rna.tf32.f32`` rounds, on the bits:
    the 13 low mantissa bits come out zero. Finite inputs only."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pairwise_kl_split_ref(logp: torch.Tensor, a_side: bool, k_pad: int):
    """The split pass of the 3xTF32 Eq. 2 strip: logp (rows,R,C) ->
    (planes (2, rows, k_pad) fp32, rowterm (rows,) fp32 or None).

    x is p = exp(l) on the A side and l on the B side; planes[0] holds
    hi(x) = tf32(x), planes[1] lo(x) = tf32(x - hi(x)), zero past R*C.
    The A side also returns rowterm = sum_k p l."""
    rows = logp.shape[0]
    lf = logp.float().reshape(rows, -1)
    x = torch.exp(lf) if a_side else lf
    hi = tf32_round(x)
    planes = torch.zeros((2, rows, k_pad), dtype=torch.float32,
                         device=logp.device)
    planes[0, :, :x.shape[1]] = hi
    planes[1, :, :x.shape[1]] = tf32_round(x - hi)
    return planes, (torch.sum(x * lf, dim=-1) if a_side else None)


def pairwise_kl_gemm_ref(a_planes: torch.Tensor, rowterm: torch.Tensor,
                         b_planes: torch.Tensor, r: int) -> torch.Tensor:
    """Eq. 2 strip from split operands: (rowterm - cross) / R with the
    cross term as hi(p) hi(l) + hi(p) lo(l) + lo(p) hi(l) (lo lo
    dropped), each product an fp32 matmul -> (U, M)."""
    (ah, al), (bh, bl) = a_planes, b_planes
    cross = ah @ bh.T + ah @ bl.T + al @ bh.T
    return (rowterm[:, None] - cross) / r


def int8_dequant_ref(q: torch.Tensor, scale: torch.Tensor,
                     zp: torch.Tensor) -> torch.Tensor:
    """Int8 wire form -> normalized log-probs, fully materialized.

    q (..., R, C) uint8 codes, scale/zp (..., R) per-row affine params
    (``core.wire.Int8``). ``zp`` cancels in the softmax but is applied so
    the result is the codec's own decode."""
    deq = (q.float() * scale.float()[..., None]
           + zp.float()[..., None])
    return torch.log_softmax(deq, dim=-1)


def int8_pairwise_kl_ref(q: torch.Tensor, scale: torch.Tensor,
                         zp: torch.Tensor) -> torch.Tensor:
    """Eq. 2 matrix of an int8-encoded repository: decode, then the dense
    pairwise KL. q (N,R,C) -> (N,N) fp32."""
    return pairwise_kl_ref(int8_dequant_ref(q, scale, zp))


def int8_pairwise_kl_pair_ref(qa: torch.Tensor, sa: torch.Tensor,
                              zpa: torch.Tensor, qb: torch.Tensor,
                              sb: torch.Tensor,
                              zpb: torch.Tensor) -> torch.Tensor:
    """Rectangular Eq. 2 strip between two int8-encoded stacks:
    qa (U,R,C), qb (M,R,C) -> (U,M) fp32."""
    return pairwise_kl_pair_ref(int8_dequant_ref(qa, sa, zpa),
                                int8_dequant_ref(qb, sb, zpb))


def soft_ce_ref(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Eq. 1 quality: g[n] = sum_i [logsumexp_c z[n,i,:] - z[n,i,y_i]].

    logits (N,R,C), labels (R,) int. A label < 0 marks a padded reference
    row and contributes 0, as in the Pallas kernel (``soft_ce.py:42``)."""
    z = logits.float()
    lse = torch.logsumexp(z, dim=-1)                        # (N,R)
    y = labels.long()
    valid = y >= 0
    idx = torch.where(valid, y, torch.zeros_like(y))
    picked = torch.gather(
        z, 2, idx[None, :, None].expand(z.shape[0], -1, 1))[..., 0]
    return torch.sum((lse - picked) * valid.float(), dim=-1)


def neighbor_mean_ref(w: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Eq. 5 targets: T[n] = sum_m w[n,m] probs[m]. w (N,N) row-stochastic,
    probs (N,R,C) -> (N,R,C) fp32."""
    n, r, c = probs.shape
    t = w.float() @ probs.float().reshape(n, r * c)
    return t.reshape(n, r, c)


def neighbor_gather_ref(nbrs: torch.Tensor, w: torch.Tensor,
                        probs: torch.Tensor) -> torch.Tensor:
    """Eq. 5 targets over the neighbor lists: T[n] = sum_j w[n,j]
    probs[nbrs[n,j]], summed in slot order j = 0..K-1. nbrs (N,K) int,
    w (N,K) fp32 (0 on unrealized slots), probs (N,R,C) -> (N,R,C) fp32;
    equal to ``neighbor_mean_ref`` on the dense W with those nonzeros."""
    n, r, c = probs.shape
    s = probs.float().reshape(n, r * c)
    idx = nbrs.long()
    t = torch.zeros_like(s)
    for j in range(idx.shape[1]):
        t += w[:, j:j + 1].float() * s[idx[:, j]]
    return t.reshape(n, r, c)
