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
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.tree import tree_leaves, tree_map  # noqa: F401 (re-exported)

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config for the assigned-architecture zoo, field for
    field: the federation's one-layer families and the LM zoo's
    architectures (``repro_torch.configs``) both build it.

    ``layer_pattern`` is the repeating unit of per-layer mixer types, e.g.
    ``("local",) * 5 + ("global",)`` for gemma3's 5:1. Valid mixer types:
    "global", "local", "mla", "ssd", "rec"; ``n_experts`` > 0 makes every
    layer's FFN a Mixture of Experts.
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
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
    sliding_window: int = 0          # window for "local" layers (0 = unused)
    layer_pattern: Tuple[str, ...] = ("global",)
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0           # decoupled rope dim per head
    v_head_dim: int = 0
    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256
    # RG-LRU (RecurrentGemma)
    lru_width: int = 0
    # modality frontend stub ("vision" | "audio" | None)
    frontend: Optional[str] = None
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: Any = torch.bfloat16
    # citation for the assigned-architecture provenance
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def n_remainder(self) -> int:
        return self.n_layers - self.n_groups * len(self.layer_pattern)

    @property
    def d_inner(self) -> int:
        """SSD inner width."""
        return self.ssm_expand * self.d_model

    def param_count(self, params) -> int:
        return sum(t.numel() for t in tree_leaves(params))

    def active_params_per_token(self) -> int:
        """Analytic N_active for 6·N·D roofline cross-checks."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        per_layer = 0
        for kind in full_pattern(self):
            if kind in ("global", "local"):
                per_layer += d * self.n_heads * self.hd          # q
                per_layer += 2 * d * self.n_kv_heads * self.hd   # k, v
                per_layer += self.n_heads * self.hd * d          # o
            elif kind == "mla":
                r, qr = self.kv_lora_rank, self.q_lora_rank
                rh, vh = self.rope_head_dim, self.v_head_dim or self.hd
                per_layer += d * (r + rh)                     # kv down (+rope)
                per_layer += r * self.n_heads * (self.hd + vh)  # kv up
                if qr:
                    per_layer += d * qr + qr * self.n_heads * (self.hd + rh)
                else:
                    per_layer += d * self.n_heads * (self.hd + rh)
                per_layer += self.n_heads * vh * d              # o
            elif kind == "ssd":
                di = self.d_inner
                per_layer += d * (2 * di + 2 * self.ssm_state
                                  + self.ssm_heads)
                per_layer += di * d
            elif kind == "rec":
                w = self.lru_width or d
                per_layer += 2 * d * w + w * d + 2 * w
            # ffn (except pure ssd layers which have none in mamba2)
            if kind != "ssd" or self.d_ff > 0:
                if self.is_moe:
                    active_e = self.moe_top_k + self.n_shared_experts
                    per_layer += active_e * 3 * d * f
                elif self.d_ff > 0:
                    per_layer += 3 * d * f
        return per_layer + 2 * v * d  # embed + head


def full_pattern(cfg: ModelConfig) -> List[str]:
    """Every layer's mixer kind, in stack order."""
    pat = list(cfg.layer_pattern) * cfg.n_groups
    return pat + list(cfg.layer_pattern)[: cfg.n_remainder]


# ---------------------------------------------------------------------------
# Initializers (every draw carries the Init's leading axis, if it has one)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Init:
    """Where params are drawn: on ``device``, from ``generator`` (None:
    torch's default), each draw stacked on a leading axis of
    ``n_clients`` rows (a cohort's clients, or the LM stack's layer
    groups), or without one when ``n_clients`` is None (one model)."""
    n_clients: Optional[int]
    device: torch.device
    generator: Optional[torch.Generator] = None

    def shape(self, shape) -> tuple:
        lead = () if self.n_clients is None else (self.n_clients,)
        return (*lead, *shape)

    def normal(self, shape, scale: float, dtype=torch.float32
               ) -> torch.Tensor:
        w = torch.randn(self.shape(shape), generator=self.generator,
                        dtype=torch.float32, device=self.device)
        return (w * scale).to(dtype)

    def full(self, shape, value: float, dtype=torch.float32
             ) -> torch.Tensor:
        return torch.full(self.shape(shape), value, dtype=dtype,
                          device=self.device)


def dense_init(init: Init, shape, dtype=torch.float32,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """N(0, 1/fan_in) weights, fan_in defaulting to ``shape[0]``."""
    fan = fan_in if fan_in is not None else shape[0]
    return init.normal(shape, 1.0 / math.sqrt(max(fan, 1)), dtype)


def embed_init(init: Init, shape, dtype) -> torch.Tensor:
    return init.normal(shape, 0.02, dtype)


def init_rmsnorm(init: Init, d: int, dtype) -> Params:
    return {"scale": init.full((d,), 1.0, dtype)}


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


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


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


# ---------------------------------------------------------------------------
# The dry run's partitioner hook
# ---------------------------------------------------------------------------
# The LM dry run (``launch/dryrun.py``) runs the steps on DTensors. Where
# DTensor's sharding propagation would leave an activation in a layout
# that a later op cannot take (a Partial written into a cache or left
# unreduced at a layer boundary; a head-sharded query under the GQA
# group view), the model hands it to the installed partitioner, which
# lays it out as GSPMD settles it. Off the dry run none is installed.
_PARTITIONER = None


def set_partitioner(partitioner) -> None:
    """An object with a method for each hook below (``pin``,
    ``attention``, ``ffn``, ``experts``, ``decode_experts``, ``ssd``,
    ``channels``, ``embed``, ``pick``, ``cache_write``, ``local``), or
    None to disable."""
    global _PARTITIONER
    _PARTITIONER = partitioner


def pin(x: torch.Tensor, like: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """``x`` in the batch layout (the batch dim over the data axes,
    replicated over the model axis), or in ``like``'s layout."""
    return x if _PARTITIONER is None else _PARTITIONER.pin(x, like)


def attention_core(fn, q, k, v, q_pos, k_pos, window: int = 0):
    """``fn(q, k, v, q_pos, k_pos, window)``, the attention core (no
    weights); a partitioner runs it on each rank's heads and keys."""
    if _PARTITIONER is None:
        return fn(q, k, v, q_pos, k_pos, window)
    return _PARTITIONER.attention(fn, q, k, v, q_pos, k_pos, window)


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; a partitioner looks each rank's vocab slice up
    (vocab-parallel, the other ranks' rows masked to 0)."""
    if _PARTITIONER is None:
        return table[tokens]
    return _PARTITIONER.embed(table, tokens)


def pick_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]`` along the last dim; a partitioner picks
    from each rank's vocab slice (vocab-parallel)."""
    if _PARTITIONER is None:
        return logits.gather(-1, labels.long()[..., None])[..., 0]
    return _PARTITIONER.pick(logits, labels)


def cache_write(buf: torch.Tensor, dim: int, slot: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
    """``buf.index_copy_(dim, slot, value)``; a partitioner writes a
    sequence-sharded cache on the rank that holds the slot."""
    if _PARTITIONER is None:
        return buf.index_copy_(dim, slot, value)
    return _PARTITIONER.cache_write(buf, dim, slot, value)


def ffn_core(fn, x, *weights):
    """``fn(x, *weights)``, a column- then row-parallel block (the dense
    FFN); a partitioner runs it on each rank's columns."""
    if _PARTITIONER is None:
        return fn(x, *weights)
    return _PARTITIONER.ffn(fn, x, *weights)


def decode_expert_core(fn, x, weights, idx, *experts):
    """``fn(x, weights, idx, *experts)``, one token's chosen experts; a
    partitioner runs it on each rank's experts or expert columns."""
    if _PARTITIONER is None:
        return fn(x, weights, idx, *experts)
    return _PARTITIONER.decode_experts(fn, x, weights, idx, *experts)


def dropless_expert_core(fn, x, weights, idx, *experts):
    """``fn(x, weights, idx, *experts)``, the dropless experts' sort and
    grouped products; a partitioner runs it on each rank's batch shard
    and its experts or expert columns."""
    if _PARTITIONER is None:
        return fn(x, weights, idx, *experts)
    return _PARTITIONER.dropless_experts(fn, x, weights, idx, *experts)


def ssd_core(fn, xh, dt, a, b, c, chunk: int):
    """``fn(xh, dt, a, b, c, chunk)``, Mamba-2's chunked scan; a
    partitioner runs it on each rank's heads."""
    if _PARTITIONER is None:
        return fn(xh, dt, a, b, c, chunk)
    return _PARTITIONER.ssd(fn, xh, dt, a, b, c, chunk)


def channel_core(fn, u, prior, *weights):
    """``fn(u, prior, *weights)``, a per-channel op over u (B,S,C) whose
    weights' last dim is the channel (a depthwise conv); a partitioner
    runs it on each rank's channels."""
    if _PARTITIONER is None:
        return fn(u, prior, *weights)
    return _PARTITIONER.channels(fn, u, prior, *weights)


def local_core(fn, x, *args):
    """``fn(x, *args)``, whose tensor results keep x's layout (a cache
    packed from the prompt's keys); a partitioner runs it on each rank's
    shard of x (and of the other tensors of ``args``, laid out as x)."""
    if _PARTITIONER is None:
        return fn(x, *args)
    return _PARTITIONER.local(fn, x, *args)


def expert_core(fn, dispatch, combine, x, *weights):
    """``fn(dispatch, combine, x, *weights)``, GShard's expert products;
    a partitioner runs it on each rank's experts or expert columns."""
    if _PARTITIONER is None:
        return fn(dispatch, combine, x, *weights)
    return _PARTITIONER.experts(fn, dispatch, combine, x, *weights)


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
