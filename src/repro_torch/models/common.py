"""Shared building blocks of the model zoo, and the stacked cohort module
every non-MLP family builds.

A family's params are a flat dict of tensors keyed by the reference's
pytree path joined with ``/`` (``"stages/0/1/w1"``, ``"mixer/wq"``), each
stacked on a leading client axis. ``StackedCohort`` holds them as
parameters and runs the family's one-client apply under
``torch.func.vmap``: the counterpart of the reference's
``jax.vmap(apply_fn)``, so each family's forward reads like the
reference's and the batching (batched matmuls) is vmap's. Clients never
interact, so one backward of the summed per-client losses gives each
client its own gradient.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config for the assigned-architecture zoo, cut to
    the fields the port's mixers read (the MoE, MLA, layer-pattern and
    frontend fields belong to the LM zoo, not ported)."""

    name: str
    family: str                      # dense | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    # attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256
    # RG-LRU
    lru_width: int = 0
    norm_eps: float = 1e-6
    param_dtype: Any = torch.bfloat16

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        """SSD inner width."""
        return self.ssm_expand * self.d_model


# ---------------------------------------------------------------------------
# Initializers (stacked: every draw carries the client axis first)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Init:
    """Where a cohort's stacked params are drawn: ``n_clients`` rows, on
    ``device``, from ``generator`` (None: torch's default)."""
    n_clients: int
    device: torch.device
    generator: Optional[torch.Generator] = None

    def normal(self, shape, scale: float, dtype=torch.float32
               ) -> torch.Tensor:
        w = torch.randn((self.n_clients, *shape), generator=self.generator,
                        dtype=torch.float32, device=self.device)
        return (w * scale).to(dtype)

    def full(self, shape, value: float, dtype=torch.float32
             ) -> torch.Tensor:
        return torch.full((self.n_clients, *shape), value, dtype=dtype,
                          device=self.device)


def dense_init(init: Init, shape, dtype=torch.float32,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """N(0, 1/fan_in) weights, fan_in defaulting to ``shape[0]``."""
    fan = fan_in if fan_in is not None else shape[0]
    return init.normal(shape, 1.0 / math.sqrt(max(fan, 1)), dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(params: Mapping[str, torch.Tensor], x: torch.Tensor,
            eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE (the half-split rotation)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)          # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None].float() * freqs      # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]               # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Masking helpers
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: int = 0) -> torch.Tensor:
    """Boolean (..., Sq, Sk) mask. window>0 adds a sliding-window band."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        m = m & (k_pos[..., None, :] > (q_pos[..., :, None] - window))
    return m


# ---------------------------------------------------------------------------
# The stacked cohort module
# ---------------------------------------------------------------------------

ApplyFn = Callable[[Params, torch.Tensor], torch.Tensor]


class StackedCohort(nn.Module):
    """``n_clients`` independent models of one family: params stacked on
    a leading client axis, forward ``(n_c, B, ...) -> (n_c, B, C)`` through
    ``torch.func.vmap`` of the one-client ``apply_fn``. ``family`` names
    the param layout (``repro_torch.convert`` reads it)."""

    def __init__(self, family: str, apply_fn: ApplyFn, params: Params):
        super().__init__()
        self.family = family
        self.apply_fn = apply_fn
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in params.items()})
        self.n_clients = int(next(iter(params.values())).shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.func.vmap(self.apply_fn)(dict(self.params), x)

    @torch.no_grad()
    def load_params(self, tensors: Mapping[str, torch.Tensor]) -> None:
        """Copy stacked tensors in, by name (e.g. from
        ``repro_torch.convert``); names and shapes must match."""
        if set(tensors) != set(self.params):
            raise ValueError(
                f"{self.family}: params {sorted(tensors)} do not match the "
                f"module's {sorted(self.params)}")
        for k, p in self.params.items():
            t = tensors[k]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{self.family}: {k} has shape "
                                 f"{tuple(t.shape)}, the module "
                                 f"{tuple(p.shape)}")
            p.copy_(t)
