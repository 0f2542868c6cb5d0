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


def tf32x3_ref(a_planes: torch.Tensor,
               b_planes: torch.Tensor) -> torch.Tensor:
    """The 3xTF32 product of split operands, A B^T as hi(a) hi(b) +
    hi(a) lo(b) + lo(a) hi(b) (lo lo dropped), each an fp32 matmul;
    planes (2, U, Kp) and (2, M, Kp) -> (U, M). The plain version of the
    GEMM's plain-store mode (the dense Eq. 5 route)."""
    (ah, al), (bh, bl) = a_planes, b_planes
    return ah @ bh.T + ah @ bl.T + al @ bh.T


def pairwise_kl_gemm_ref(a_planes: torch.Tensor, rowterm: torch.Tensor,
                         b_planes: torch.Tensor, r: int) -> torch.Tensor:
    """Eq. 2 strip from split operands: (rowterm - cross) / R with the
    cross term ``tf32x3_ref`` -> (U, M)."""
    return (rowterm[:, None] - tf32x3_ref(a_planes, b_planes)) / r


def int8_dequant_ref(q: torch.Tensor, scale: torch.Tensor,
                     zp: torch.Tensor) -> torch.Tensor:
    """Int8 wire form -> normalized log-probs, fully materialized.

    q (..., R, C) uint8 codes, scale/zp (..., R) per-row affine params
    (``core.wire.Int8``). ``zp`` cancels in the softmax but is applied so
    the result is the codec's own decode."""
    deq = (q.float() * scale.float()[..., None]
           + zp.float()[..., None])
    return torch.log_softmax(deq, dim=-1)


def int8_decode_ref(q: torch.Tensor, scale: torch.Tensor,
                    lse: torch.Tensor) -> torch.Tensor:
    """Int8 wire form -> log-probs through the row statistics, as the
    IVF index reconstructs a row: l = q·scale − lse, lse (..., R) =
    logsumexp_c(q·scale). q (..., R, C) -> (..., R, C) fp32."""
    return q.float() * scale.float()[..., None] - lse.float()[..., None]


def int8_pairwise_kl_split_ref(q: torch.Tensor, scale: torch.Tensor,
                               lse: torch.Tensor, a_side: bool, k_pad: int):
    """The dequant split of the int8 Eq. 2 strip: the split pass
    (``pairwise_kl_split_ref``) of the decoded l = q·scale − lse."""
    return pairwise_kl_split_ref(int8_decode_ref(q, scale, lse), a_side,
                                 k_pad)


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


def neighbor_mean_split_ref(probs: torch.Tensor,
                            k_pad: int) -> torch.Tensor:
    """The transposing split of the dense Eq. 5 route: probs (N,R,C) ->
    planes (2, R*C, k_pad) fp32 of S^T, hi = tf32(S^T) and lo =
    tf32(S^T - hi), zero for n >= N."""
    n = probs.shape[0]
    st = probs.float().reshape(n, -1).T
    hi = tf32_round(st)
    planes = torch.zeros((2, st.shape[0], k_pad), dtype=torch.float32,
                         device=probs.device)
    planes[0, :, :n] = hi
    planes[1, :, :n] = tf32_round(st - hi)
    return planes


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


def ragged_dot_ref(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor,
                   transpose_rhs: bool = False) -> torch.Tensor:
    """``jax.lax.ragged_dot``: lhs (M,K) with its rows sorted by group,
    rhs (G,K,N) (``transpose_rhs``: (G,N,K), each group's read as its
    transpose), group_sizes (G,) -> (M,N) in lhs's dtype. Group g's rows
    go through rhs[g] in one product; rows at or past sum(group_sizes)
    come out 0. The group sizes are read on the host."""
    m = lhs.shape[0]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    outs, start = [], 0
    for g, size in enumerate(group_sizes.tolist()):
        size = max(0, min(size, m - start))
        if size:
            w = rhs[g].transpose(0, 1) if transpose_rhs else rhs[g]
            outs.append(lhs[start:start + size] @ w)
            start += size
    if start < m or not outs:
        outs.append(lhs.new_zeros((m - start, n)))
    return torch.cat(outs)


def ragged_dot_wgrad_ref(lhs: torch.Tensor, grad: torch.Tensor,
                         group_sizes: torch.Tensor) -> torch.Tensor:
    """The weight gradient of ``ragged_dot_ref``: lhs (M,K), grad (M,N),
    group_sizes (G,) -> (G,K,N) in lhs's dtype, group g's lhs rows
    transposed times its grad rows (0 for an empty group); rows at or past
    sum(group_sizes) take no part."""
    m, k = lhs.shape
    out = lhs.new_zeros((group_sizes.shape[0], k, grad.shape[1]))
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        size = max(0, min(size, m - start))
        if size:
            out[g] = lhs[start:start + size].t().mm(grad[start:start + size])
            start += size
    return out


def ragged_dot_wgrad_tf32_split_ref(x: torch.Tensor,
                                    group_sizes: torch.Tensor,
                                    m_pad: int) -> torch.Tensor:
    """The fp32 weight gradient's transposing split: x (M, C) with its rows
    sorted by group -> planes (2, C, m_pad) fp32 of x^T, hi and lo as the
    split pass rounds them, group g's rows (sizes clamped at 0, the
    running sum at M) from column 32 T(g) on, T(g) the 32-row stages of
    the groups before it, zero elsewhere. The group sizes are read on the
    host."""
    m, c = x.shape
    hi = tf32_round(x)
    lo = tf32_round(x.float() - hi)
    planes = torch.zeros((2, c, m_pad), dtype=torch.float32, device=x.device)
    start = col = 0
    for size in group_sizes.tolist():
        size = max(0, min(size, m - start))
        planes[0, :, col:col + size] = hi[start:start + size].T
        planes[1, :, col:col + size] = lo[start:start + size].T
        start += size
        col += -(-size // 32) * 32
    return planes

