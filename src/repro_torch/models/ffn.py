"""Feed-forward layers: the dense SwiGLU FFN and the Mixture-of-Experts FFN.

MoE params: ``router (D, E)`` in fp32, ``w_gate``/``w_up (E, D, F)`` and
``w_down (E, F, D)`` in ``param_dtype``, and ``shared``, one dense FFN of
width ``n_shared_experts * d_ff``, where the config has shared experts.
Three paths, the reference's:

  * ``moe_gshard_forward``: dispatch and combine products with a
    per-row expert capacity; the choices past it are dropped;
  * ``moe_dropless_forward``: the choices sorted by expert (a stable
    sort), then three grouped products over them (``kernels.ops.
    ragged_dot``, ``jax.lax.ragged_dot``'s counterpart), group sizes
    counted on the device;
  * ``moe_decode``: one token per row, the k chosen experts' weights
    gathered per row.

Routing ties go to the lowest expert index, as ``jax.lax.top_k``'s, on
every device. The router product is fp32 and must stay IEEE fp32 on the
card (no TF32): a near tie at the k-th logit flips a whole expert.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import (Init, ModelConfig, Params, dense_init,
                                       decode_expert_core,
                                       dropless_expert_core, expert_core,
                                       ffn_core, swiglu)

MOE_CAPACITY_FACTOR = 1.25


def init_dense_ffn(init: Init, cfg: ModelConfig, d_ff: int = 0) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    return {"w_gate": dense_init(init, (d, f), dt),
            "w_up": dense_init(init, (d, f), dt),
            "w_down": dense_init(init, (f, d), dt, fan_in=f)}


def init_moe(init: Init, cfg: ModelConfig) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.param_dtype
    p = {"router": dense_init(init, (d, e), torch.float32),
         "w_gate": dense_init(init, (e, d, f), dt),
         "w_up": dense_init(init, (e, d, f), dt),
         "w_down": dense_init(init, (e, f, d), dt, fan_in=f)}
    if cfg.n_shared_experts > 0:
        p["shared"] = init_dense_ffn(init, cfg, cfg.n_shared_experts * f)
    return p


def dense_ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    return ffn_core(_swiglu_ffn, x, p["w_gate"], p["w_up"], p["w_down"])


def _swiglu_ffn(x, w_gate, w_up, w_down):
    g = torch.einsum("bsd,df->bsf", x, w_gate)
    u = torch.einsum("bsd,df->bsf", x, w_up)
    return torch.einsum("bsf,fd->bsd", swiglu(g, u).to(x.dtype), w_down)


# ---------------------------------------------------------------------------
# routing (shared by all MoE paths)
# ---------------------------------------------------------------------------

def route(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """x (..., D) -> (combine weights (..., k) fp32, expert indices
    (..., k) int64, Switch load-balance aux loss () fp32).

    The top k are the first k of a stable descending sort, so equal
    logits go to the lowest index (``torch.topk`` promises no order)."""
    if x.is_cuda and (torch.get_float32_matmul_precision() != "highest"
                      or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "MoE routing needs IEEE fp32 router logits: TF32 matmuls are on "
            "(torch.set_float32_matmul_precision('highest') turns them off)")
    logits = torch.einsum("...d,de->...e", x.float(), p["router"])
    k, e = cfg.moe_top_k, cfg.n_experts
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    weights = torch.softmax(vals, dim=-1)
    me = torch.softmax(logits, dim=-1).reshape(-1, e).mean(dim=0)
    ce = F.one_hot(idx.reshape(-1), e).float().mean(dim=0)
    aux = e * torch.sum(me * ce)
    return weights, idx, aux


def gshard_capacity(cfg: ModelConfig, s: int,
                    capacity_factor: float = MOE_CAPACITY_FACTOR) -> int:
    """Slots per expert and batch row: s k / E times the factor, Python's
    (banker's) round, rounded up to a multiple of 16."""
    cap = int(max(1, round(s * cfg.moe_top_k / cfg.n_experts
                           * capacity_factor)))
    return -(-cap // 16) * 16


# ---------------------------------------------------------------------------
# the three paths
# ---------------------------------------------------------------------------

def _gshard_experts(dispatch, combine, x, w_gate, w_up, w_down):
    """The experts' products between GShard's dispatch and combine:
    (B,S,E,C) one-hots and weights, x (B,S,D) -> y (B,S,D)."""
    xe = torch.einsum("bsec,bsd->becd", dispatch, x)        # (B,E,C,D)
    g = torch.einsum("becd,edf->becf", xe, w_gate)
    u = torch.einsum("becd,edf->becf", xe, w_up)
    h = swiglu(g, u)
    ye = torch.einsum("becf,efd->becd", h.float(),
                      w_down.float()).to(x.dtype)
    return torch.einsum("bsec,becd->bsd", combine, ye)


def moe_gshard_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                       capacity_factor: float = MOE_CAPACITY_FACTOR):
    """x (B,S,D) -> (y, aux). Each (token, choice) takes the next slot of
    its expert's buffer in token-major order; past the capacity it is
    dropped (contributes nothing)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = gshard_capacity(cfg, s, capacity_factor)
    weights, idx, aux = route(p, cfg, x)                    # (B,S,k)
    oh = F.one_hot(idx, e)                                  # (B,S,k,E)
    oh_flat = oh.reshape(b, s * k, e)
    pos_in_e = (torch.cumsum(oh_flat, dim=1) * oh_flat - 1).reshape(
        b, s, k, e)
    # slot c of expert e: an unchosen expert (-1) and a dropped choice
    # (>= cap) match no slot, as the reference's one_hot(-1) is all zeros
    slots = torch.arange(cap, device=x.device)
    cap_oh = (pos_in_e[..., None] == slots).to(x.dtype)     # (B,S,k,E,C)
    dispatch = cap_oh.sum(dim=2)                            # (B,S,E,C)
    combine = (cap_oh * weights[..., None, None].to(x.dtype)).sum(dim=2)
    y = expert_core(_gshard_experts, dispatch, combine, x, p["w_gate"],
                    p["w_up"], p["w_down"])
    if "shared" in p:
        y = y + dense_ffn(p["shared"], x)
    return y, aux


def _dropless_experts(x, weights, idx, w_gate, w_up, w_down):
    """x (B,S,D), the routing weights and indices (B,S,k) -> y (B,S,D)
    in x's dtype. The (token, choice) rows are sorted by expert (stable)
    and go through the experts' FFN in three grouped products
    (``ragged_dot``), the group sizes counted on the device; each token's
    k weighted outputs are summed in x's dtype in the sorted order,
    ascending expert, as the reference's scatter-add sums them:
    deterministic, where ``index_add_`` on the card is not. An index equal
    to the experts' count (another rank's expert, weighted 0) sorts last,
    past the groups: the products give its row 0."""
    b, s, d = x.shape
    k, e = idx.shape[-1], w_gate.shape[0]
    t = b * s
    xf = x.reshape(t, d)
    ef = idx.reshape(t * k)
    order = torch.argsort(ef, stable=True)
    xs = xf[order // k]                                     # (t*k, D)
    sizes = torch.zeros(e + 1, dtype=torch.int32, device=x.device)
    sizes = sizes.scatter_add_(0, ef, torch.ones_like(ef, dtype=torch.int32))
    sizes = sizes[:e]
    h = swiglu(ops.ragged_dot(xs, w_gate, sizes),
               ops.ragged_dot(xs, w_up, sizes))
    ys = ops.ragged_dot(h, w_down, sizes)                   # (t*k, D)
    yw = ys * weights.reshape(t * k)[order][:, None].to(ys.dtype)
    per_choice = torch.empty_like(yw)
    per_choice[order] = yw                                  # (t*k, D)
    by_expert = torch.argsort(idx.reshape(t, k), dim=1)
    parts = per_choice.reshape(t, k, d).gather(
        1, by_expert[..., None].expand(t, k, d))
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]
    return y.reshape(b, s, d).to(x.dtype)


def moe_dropless_forward(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """x (B,S,D) -> (y, aux), no choice dropped: the experts' products
    over the choices sorted by expert (``_dropless_experts``), with no
    host sync."""
    weights, idx, aux = route(p, cfg, x)
    y = dropless_expert_core(_dropless_experts, x, weights, idx,
                             p["w_gate"], p["w_up"], p["w_down"])
    if "shared" in p:
        y = y + dense_ffn(p["shared"], x)
    return y, aux


def _decode_experts(x, weights, idx, w_gate, w_up, w_down):
    """x (B,1,D), the routing weights and indices (B,1,k) -> y (B,1,D)."""
    idxf = idx[:, 0]                                        # (B,k)
    xe = x[:, :, None, :]                                   # (B,1,1,D)
    g = torch.matmul(xe, w_gate[idxf])                      # (B,k,1,F)
    u = torch.matmul(xe, w_up[idxf])
    h = swiglu(g, u)
    ye = torch.matmul(h.float(), w_down[idxf].float())[:, :, 0]
    return torch.einsum("bkd,bk->bd", ye, weights[:, 0])[:, None, :].to(
        x.dtype)


def moe_decode(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """x (B,1,D) -> (y, aux): the k chosen experts' weights gathered per
    row, (B,k,D,F) each (mixtral-8x7b at batch 4: 2.82 GB of bf16 copies
    a layer), then one product per (row, choice); no host sync."""
    b, s, d = x.shape
    if s != 1:
        raise ValueError(f"moe_decode expects one token per row, got S={s}")
    weights, idx, aux = route(p, cfg, x)                    # (B,1,k)
    y = decode_expert_core(_decode_experts, x, weights, idx, p["w_gate"],
                           p["w_up"], p["w_down"])
    if "shared" in p:
        y = y + dense_ffn(p["shared"], x)
    return y, aux


def moe_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                path: str = "gshard"):
    if path == "gshard":
        return moe_gshard_forward(p, cfg, x)
    if path == "dropless":
        return moe_dropless_forward(p, cfg, x)
    raise ValueError(f"unknown moe path {path!r}")
