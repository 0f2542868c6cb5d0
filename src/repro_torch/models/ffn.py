"""Feed-forward layers: the dense SwiGLU FFN.

The Mixture-of-Experts FFN (the reference's GShard, dropless and decode
paths, ``repro/models/ffn.py:74-194``) is declared here and waits for the
MoE/MLA slice, with mixtral-8x7b and deepseek-v2-236b.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import (Init, ModelConfig, Params, dense_init,
                                       swiglu)

_MOE = ("the Mixture-of-Experts FFN is not ported yet: it comes with the "
        "MoE/MLA slice")


def init_dense_ffn(init: Init, cfg: ModelConfig, d_ff: int = 0) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    return {"w_gate": dense_init(init, (d, f), dt),
            "w_up": dense_init(init, (d, f), dt),
            "w_down": dense_init(init, (f, d), dt, fan_in=f)}


def dense_ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
    u = torch.einsum("bsd,df->bsf", x, p["w_up"])
    return torch.einsum("bsf,fd->bsd", swiglu(g, u).to(x.dtype), p["w_down"])


def init_moe(init: Init, cfg: ModelConfig) -> Params:
    raise NotImplementedError(_MOE)


def moe_forward(p: Params, cfg: ModelConfig, x, path: str = "gshard"):
    raise NotImplementedError(_MOE)


def moe_decode(p: Params, cfg: ModelConfig, x):
    raise NotImplementedError(_MOE)
