"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427],
the full-sequence path.

Two parallel branches from (B,S,D): a gate branch GeLU(W_y x) and a
recurrent branch conv1d(W_x x) -> RG-LRU linear recurrence, merged
multiplicatively and projected back to D. The recurrence
``h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)`` runs as a loop over
the sequence; the reference's associative scan adds the same terms in a
tree, so the two agree to fp32 rounding, not bit for bit. The gates are
block-diagonal ``(nb, wb, wb)``, as in the reference. Decode is one
step of the recurrence against a cache ``{'state': (B,W) fp32,
'conv': (B,W-1,W)}``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (Init, ModelConfig, Params,
                                       channel_core, dense_init, local_core,
                                       pin)

_C = 8.0  # RG-LRU gate temperature (Griffin's fixed constant)

GATE_BLOCKS = 16


def _gate_blocks(w: int) -> int:
    nb = GATE_BLOCKS
    while w % nb:
        nb //= 2
    return max(nb, 1)


def init_rglru(init: Init, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    w = cfg.lru_width or d
    nb = _gate_blocks(w)
    wb = w // nb
    dt = cfg.param_dtype
    return {
        "w_y": dense_init(init, (d, w), dt),                # gate branch
        "w_x": dense_init(init, (d, w), dt),                # recurrent branch
        "conv_w": dense_init(init, (cfg.conv_width, w), dt,
                             fan_in=cfg.conv_width),
        "conv_b": init.full((w,), 0.0, dt),
        "w_a": dense_init(init, (nb, wb, wb), fan_in=wb),
        "b_a": init.full((w,), 0.0),
        "w_i": dense_init(init, (nb, wb, wb), fan_in=wb),
        "b_i": init.full((w,), 0.0),
        # Λ so that a = sigmoid(Λ) lies in [0.9, 0.999] (Griffin's init)
        "lam": torch.linspace(2.2, 6.9, w, dtype=torch.float32,
                              device=init.device).expand(
                                  init.shape((w,))).clone(),
        "w_out": dense_init(init, (w, d), dt, fan_in=w),
    }


def _conv(p: Params, u: torch.Tensor,
          prior: torch.Tensor = None) -> torch.Tensor:
    """Depthwise causal conv of width W over u (B,S,W); ``prior``
    (B,W-1,W) is the history before u (None: zeros)."""
    return channel_core(_depthwise, u, prior, p["conv_w"], p["conv_b"])


def _depthwise(u, prior, w, b):
    width, s = w.shape[0], u.shape[1]
    up = (F.pad(u, (0, 0, width - 1, 0)) if prior is None
          else torch.cat([prior, u], dim=1))
    out = up[:, 0:s, :] * w[0]
    for i in range(1, width):
        out = out + up[:, i:i + s, :] * w[i]
    return (out + b).to(u.dtype)


def _gates(p: Params, xr: torch.Tensor):
    """(a_t, gated input), both fp32, from xr (B,S,W) through the
    block-diagonal gate matmuls."""
    xf = xr.float()
    nb, wb, _ = p["w_a"].shape
    xb = xf.reshape(*xf.shape[:-1], nb, wb)
    r = torch.sigmoid(torch.einsum("...nw,nwv->...nv", xb, p["w_a"])
                      .reshape(xf.shape) + p["b_a"])
    i = torch.sigmoid(torch.einsum("...nw,nwv->...nv", xb, p["w_i"])
                      .reshape(xf.shape) + p["b_i"])
    log_a = -_C * r * F.softplus(p["lam"])                  # log a_t <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 (S), from h_{-1} = 0 (the steps'
    slices taken once: two ops a step)."""
    a_t, b_t = a.unbind(1), b.unbind(1)
    h = b_t[0]
    out = [h]
    for t in range(1, len(a_t)):
        h = a_t[t] * h + b_t[t]
        out.append(h)
    return torch.stack(out, dim=1)


def rglru_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  return_state: bool = False):
    """Full-sequence recurrent block. x (B,S,D). With ``return_state``
    also the decode cache: the last step's state and the recurrent
    branch's last W-1 inputs to the conv."""
    # jax.nn.gelu defaults to the tanh approximation
    y_gate = F.gelu(torch.einsum("bsd,dw->bsw", x, p["w_y"]).float(),
                    approximate="tanh")
    conv_in = torch.einsum("bsd,dw->bsw", x, p["w_x"])
    a, b = _gates(p, _conv(p, conv_in))
    h = local_core(rglru_scan, a, b)                        # (B,S,W) fp32
    merged = (h * y_gate).to(x.dtype)
    out = torch.einsum("bsw,wd->bsd", merged, p["w_out"])
    if return_state:
        return out, {"state": h[:, -1, :].clone(),
                     "conv": conv_in[:, -(cfg.conv_width - 1):, :].clone()}
    return out


def rglru_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 cache: Params):
    """One-token step. x (B,1,D); cache {'state': (B,W) fp32,
    'conv': (B,W-1,W)}, updated in place and returned."""
    y_gate = F.gelu(torch.einsum("bsd,dw->bsw", x, p["w_y"]).float(),
                    approximate="tanh")
    xr = torch.einsum("bsd,dw->bsw", x, p["w_x"])           # (B,1,W)
    new_conv = torch.cat([cache["conv"][:, 1:], xr], dim=1)
    a, b = _gates(p, _conv(p, xr, prior=cache["conv"]))     # (B,1,W)
    h = a[:, 0] * cache["state"] + b[:, 0]                  # (B,W)
    merged = (h[:, None, :] * y_gate).to(x.dtype)
    # fp32 accumulation, one rounding to x's dtype: as ssm.ssd_decode's
    out = torch.einsum("bsw,wd->bsd", merged, p["w_out"])
    cache["state"].copy_(pin(h, cache["state"]))
    cache["conv"].copy_(pin(new_conv, cache["conv"]))
    return out, cache


def rglru_init_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Params:
    w = cfg.lru_width or cfg.d_model
    return {
        "state": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
    }
