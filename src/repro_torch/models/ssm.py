"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060], the
full-sequence chunked form.

Within a chunk the SSD output is an attention-like quadratic product;
across chunks a small recurrent state is handed on (a loop over the
chunks). Single B/C group, scalar-per-head A. The in-projection stays
the reference's fused ``w_in (D, 2*di + 2*N + H)``, split after the
product. Decode is the constant-memory recurrence against a cache
``{'state': (B,H,P,N) fp32, 'conv': (B,W-1,C)}``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (Init, ModelConfig, Params,
                                       channel_core, dense_init, pin,
                                       ssd_core)


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    di = cfg.d_inner
    h = cfg.ssm_heads
    return di, h, di // h, cfg.ssm_state


def init_ssd(init: Init, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    di, h, p, n = _dims(cfg)
    dt = cfg.param_dtype
    conv_ch = di + 2 * n                       # conv over [x, B, C]
    return {
        # in_proj -> [z (di), x (di), B (n), C (n), dt (h)]
        "w_in": dense_init(init, (d, 2 * di + 2 * n + h), dt),
        "conv_w": dense_init(init, (cfg.conv_width, conv_ch), dt,
                             fan_in=cfg.conv_width),
        "conv_b": init.full((conv_ch,), 0.0, dt),
        "a_log": init.full((h,), 0.0),                     # A = -exp(a_log)
        "dt_bias": init.full((h,), 0.0),
        "d_skip": init.full((h,), 1.0),
        "norm_scale": init.full((di,), 1.0, dt),           # gated RMSNorm
        "w_out": dense_init(init, (di, d), dt, fan_in=di),
    }


def _split_in(p: Params, cfg: ModelConfig, x: torch.Tensor):
    di, h, _, n = _dims(cfg)
    proj = torch.einsum("bsd,de->bse", x, p["w_in"])
    return (proj[..., :di], proj[..., di:2 * di],
            proj[..., 2 * di:2 * di + n], proj[..., 2 * di + n:2 * di + 2 * n],
            proj[..., 2 * di + 2 * n:])


def _gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor,
                eps: float) -> torch.Tensor:
    yf = (y * F.silu(z.float())).float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return yf * torch.rsqrt(var + eps) * p["norm_scale"].float()


def _causal_conv(p: Params, u: torch.Tensor,
                 prior: torch.Tensor = None) -> torch.Tensor:
    """Depthwise causal conv of width W over u (B,S,C), then SiLU;
    ``prior`` (B,W-1,C) is the history before u (None: zeros)."""
    return channel_core(_conv_silu, u, prior, p["conv_w"], p["conv_b"])


def _conv_silu(u, prior, w, b):
    width, s = w.shape[0], u.shape[1]                       # w (W, C)
    up = (F.pad(u, (0, 0, width - 1, 0)) if prior is None
          else torch.cat([prior, u], dim=1))
    out = up[:, 0:s, :] * w[0]
    for i in range(1, width):
        out = out + up[:, i:i + s, :] * w[i]
    return F.silu((out + b).float()).to(u.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., q) -> (..., q, q) with S[i,j] = sum_{j<k<=i} x[k] on and
    below the diagonal and -inf above it, so that exp gives exact zeros
    there."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, -torch.inf)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_: torch.Tensor, c_: torch.Tensor, chunk: int):
    """Chunked SSD.

    xh (B,S,H,P) head inputs; dt (B,S,H) positive step sizes; a (H,)
    negative; b_/c_ (B,S,N) single-group projections. Returns
    (y (B,S,H,P) fp32, final state (B,H,P,N) fp32)."""
    bsz, s, h, p = xh.shape
    n = b_.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_ = F.pad(b_, (0, 0, 0, pad))
        c_ = F.pad(c_, (0, 0, 0, pad))
    q = chunk
    xc = xh.reshape(bsz, nc, q, h, p).float()
    dtc = dt.reshape(bsz, nc, q, h).float()
    bc = b_.reshape(bsz, nc, q, n).float()
    cc = c_.reshape(bsz, nc, q, n).float()

    da = dtc * a                                            # (B,C,Q,H) <= 0
    da_cs = torch.cumsum(da, dim=2)                         # within-chunk
    x_dt = xc * dtc[..., None]                              # discretized input

    # 1) within-chunk (quadratic): L[b,c,h,i,j] decay, i >= j
    l_mat = torch.exp(_segsum(da.permute(0, 1, 3, 2)))      # (B,C,H,Q,Q)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)            # (B,C,Q,Q)
    y_diag = torch.einsum("bcij,bchij,bcjhp->bcihp", cb, l_mat, x_dt)

    # 2) per-chunk end states
    decay_to_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)   # (B,C,Q,H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bc, decay_to_end, x_dt)

    # 3) cross-chunk recurrence over the chunk index
    chunk_decay = torch.exp(torch.sum(da, dim=2))           # (B,C,H)
    carry = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                        device=xh.device)
    prev = []
    for ci in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                  # (B,C,H,P,N)

    # 4) contribution of previous chunks' state
    in_decay = torch.exp(da_cs)                             # (B,C,Q,H)
    y_off = torch.einsum("bcin,bchpn,bcih->bcihp", cc, prev_states, in_decay)

    y = (y_diag + y_off).reshape(bsz, nc * q, h, p)[:, :s]
    return y, carry


def ssd_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence Mamba-2 mixer. x (B,S,D) -> (B,S,D). With
    ``return_state`` also the decode cache after the last token: the
    final SSM state (the padded tail of the last chunk has dt = 0, so it
    leaves the state as it was) and the conv input's last W-1 rows."""
    di, h, ph, n = _dims(cfg)
    z, xin, b_, c_, dt_raw = _split_in(p, cfg, x)
    conv_in = torch.cat([xin, b_, c_], dim=-1)
    conv_out = _causal_conv(p, conv_in)
    xin, b_, c_ = (conv_out[..., :di], conv_out[..., di:di + n],
                   conv_out[..., di + n:])
    # torch's softplus returns its input above 20, where log1p(exp(-x))
    # < 2.1e-9 is below half an fp32 ulp of x: JAX's logaddexp(x, 0)
    # rounds to the same value
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xh = xin.reshape(*xin.shape[:2], h, ph)
    y, state = ssd_core(ssd_scan, xh, dt, a, b_, c_, cfg.ssm_chunk)
    y = y + p["d_skip"][:, None] * xh.float()
    y = y.reshape(*x.shape[:2], di)
    y = _gated_norm(p, y, z, cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y.to(x.dtype), p["w_out"])
    if return_state:
        conv_tail = conv_in[:, -(cfg.conv_width - 1):, :].clone()
        return out, {"state": state, "conv": conv_tail}
    return out


def ssd_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params):
    """One-token recurrent step. x (B,1,D); cache {'state': (B,H,P,N),
    'conv': (B,W-1,C)}, updated in place and returned."""
    di, h, ph, n = _dims(cfg)
    z, xin, b_, c_, dt_raw = _split_in(p, cfg, x)           # all (B,1,.)
    conv_in = torch.cat([xin, b_, c_], dim=-1)              # (B,1,C)
    conv_out = _causal_conv(p, conv_in, prior=cache["conv"])
    new_conv = torch.cat([cache["conv"][:, 1:], conv_in], dim=1)
    xin, b_, c_ = (conv_out[..., :di], conv_out[..., di:di + n],
                   conv_out[..., di + n:])
    dt = F.softplus(dt_raw.float() + p["dt_bias"])[:, 0]    # (B,H)
    a = -torch.exp(p["a_log"])
    xh = xin[:, 0].reshape(-1, h, ph).float()               # (B,H,P)
    bv = b_[:, 0].float()                                   # (B,N)
    cv = c_[:, 0].float()
    decay = torch.exp(dt * a)                               # (B,H)
    dx = xh * dt[..., None]                                 # (B,H,P)
    state = (cache["state"] * decay[..., None, None]
             + torch.einsum("bhp,bn->bhpn", dx, bv))
    y = torch.einsum("bhpn,bn->bhp", state, cv) + p["d_skip"][:, None] * xh
    y = _gated_norm(p, y.reshape(x.shape[0], 1, di), z, cfg.norm_eps)
    # the reference accumulates in fp32, then casts to x's dtype; torch's
    # bf16 matmul accumulates in fp32 and rounds its output once, the same
    # (cuBLAS may reduce split-K partials in bf16 unless
    # allow_bf16_reduced_precision_reduction is off)
    out = torch.einsum("bse,ed->bsd", y.to(x.dtype), p["w_out"])
    cache["state"].copy_(pin(state, cache["state"]))
    cache["conv"].copy_(pin(new_conv, cache["conv"]))
    return out, cache


def ssd_init_cache(cfg: ModelConfig, batch: int, dtype,
                   device=None) -> Params:
    di, h, ph, n = _dims(cfg)
    return {
        "state": torch.zeros((batch, h, ph, n), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * n),
                            dtype=dtype, device=device),
    }
