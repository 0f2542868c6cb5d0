"""The paper's own heterogeneous client families: ResNet-1D 8/20/50.

§IV-B: the ResNets' 2D convolutions become 1D ones for the time series
(SC, PAD). Inputs are (B, L) or (B, L, C_in) series; inside, activations
are channels-first ``(B, C, L)``.

Depth layout (CIFAR-style 3-stage ResNet): 8 -> (1,1,1) basic blocks,
20 -> (3,3,3) basic, 50 -> bottleneck (3,4,6).

Two details keep the forward the reference's:
  * "SAME" padding at stride s pads ``total = max((ceil(L/s) - 1) * s + K
    - L, 0)``, ``total // 2`` low and the rest high (at L=64, K=3, s=2
    that is (0, 1); ``conv1d(padding=1)`` would pad (1, 1));
  * the norm is GroupNorm(1) with the biased variance over (C, L), then a
    per-channel scale and bias.
Conv weights are ``(C_out, C_in, K)``; ``repro_torch.convert`` transposes
the reference's HIO ``(K, C_in, C_out)`` into it.

A convolution is a matmul over its (C_in, K) windows, not ``F.conv1d``:
cuDNN runs fp32 convolutions in TF32 unless the process turns that off
(``torch.backends.cudnn.allow_tf32`` defaults to True), while a matmul
stays fp32 unless the caller asks for TF32 matmuls. So the card trains
the ResNets in fp32, as the reference and the rest of the port do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Init, Params, StackedCohort


@dataclasses.dataclass(frozen=True)
class ResNet1DConfig:
    name: str
    blocks: Tuple[int, ...] = (1, 1, 1)
    width: int = 16
    bottleneck: bool = False
    n_classes: int = 3
    in_channels: int = 1
    pool_stride: int = 2


RESNET8 = ResNet1DConfig("resnet8-1d", (1, 1, 1), 16, False)
RESNET20 = ResNet1DConfig("resnet20-1d", (3, 3, 3), 16, False)
RESNET50 = ResNet1DConfig("resnet50-1d", (3, 4, 6), 16, True)


def same_pads(length: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's "SAME" convolution."""
    total = max((-(-length // stride) - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


def _conv1d(w: torch.Tensor, x: torch.Tensor, stride: int = 1
            ) -> torch.Tensor:
    """x (B, Cin, L), w (Cout, Cin, K) -> (B, Cout, ceil(L/stride))."""
    k = w.shape[-1]
    x = F.pad(x, same_pads(x.shape[-1], k, stride))
    return torch.einsum("bclk,ock->bol", x.unfold(-1, k, stride), w)


def _norm(scale, bias, x):
    """GroupNorm(1), batch-size independent (on-device batches are tiny)."""
    m = torch.mean(x, dim=(1, 2), keepdim=True)
    v = torch.var(x, dim=(1, 2), keepdim=True, correction=0)
    return (x - m) * torch.rsqrt(v + 1e-5) * scale[:, None] + bias[:, None]


def _conv_init(init: Init, width: int, c_in: int, c_out: int):
    return init.normal((c_out, c_in, width), 1.0 / math.sqrt(width * c_in))


def _init_block(init: Init, prefix: str, c_in: int, c_out: int,
                bottleneck: bool) -> Params:
    ones = lambda c: init.full((c,), 1.0)
    zeros = lambda c: init.full((c,), 0.0)
    if bottleneck:
        mid = c_out // 4
        p = {"w1": _conv_init(init, 1, c_in, mid),
             "w2": _conv_init(init, 3, mid, mid),
             "w3": _conv_init(init, 1, mid, c_out),
             "s1": ones(mid), "b1": zeros(mid),
             "s2": ones(mid), "b2": zeros(mid),
             "s3": ones(c_out), "b3": zeros(c_out)}
    else:
        p = {"w1": _conv_init(init, 3, c_in, c_out),
             "w2": _conv_init(init, 3, c_out, c_out),
             "s1": ones(c_out), "b1": zeros(c_out),
             "s2": ones(c_out), "b2": zeros(c_out)}
    if c_in != c_out:
        p["w_skip"] = _conv_init(init, 1, c_in, c_out)
    return {f"{prefix}/{k}": v for k, v in p.items()}


def _apply_block(p: Params, prefix: str, x: torch.Tensor, stride: int,
                 bottleneck: bool) -> torch.Tensor:
    g = lambda k: p[f"{prefix}/{k}"]
    skip = x
    if f"{prefix}/w_skip" in p:
        skip = _conv1d(g("w_skip"), x, stride)
    elif stride > 1:
        skip = x[:, :, ::stride]
    if bottleneck:
        h = F.relu(_norm(g("s1"), g("b1"), _conv1d(g("w1"), x, 1)))
        h = F.relu(_norm(g("s2"), g("b2"), _conv1d(g("w2"), h, stride)))
        h = _norm(g("s3"), g("b3"), _conv1d(g("w3"), h, 1))
    else:
        h = F.relu(_norm(g("s1"), g("b1"), _conv1d(g("w1"), x, stride)))
        h = _norm(g("s2"), g("b2"), _conv1d(g("w2"), h, 1))
    return F.relu(h + skip)


def init_resnet1d(init: Init, cfg: ResNet1DConfig) -> Params:
    mult = 4 if cfg.bottleneck else 1
    p: Params = {"stem": _conv_init(init, 3, cfg.in_channels, cfg.width),
                 "stem_s": init.full((cfg.width,), 1.0),
                 "stem_b": init.full((cfg.width,), 0.0)}
    c_in = cfg.width
    for stage, n_blocks in enumerate(cfg.blocks):
        c_out = cfg.width * (2 ** stage) * mult
        for b in range(n_blocks):
            p.update(_init_block(init, f"stages/{stage}/{b}", c_in, c_out,
                                 cfg.bottleneck))
            c_in = c_out
    p["head_w"] = init.normal((c_in, cfg.n_classes), 1.0 / math.sqrt(c_in))
    p["head_b"] = init.full((cfg.n_classes,), 0.0)
    return p


def apply_resnet1d(cfg: ResNet1DConfig, p: Params,
                   x: torch.Tensor) -> torch.Tensor:
    """One client: x (B, L) or (B, L, C_in) -> logits (B, n_classes)."""
    x = x[:, None, :] if x.dim() == 2 else x.transpose(1, 2)
    h = F.relu(_norm(p["stem_s"], p["stem_b"], _conv1d(p["stem"], x)))
    for stage, n_blocks in enumerate(cfg.blocks):
        for b in range(n_blocks):
            stride = cfg.pool_stride if (b == 0 and stage > 0) else 1
            h = _apply_block(p, f"stages/{stage}/{b}", h, stride,
                             cfg.bottleneck)
    h = torch.mean(h, dim=2)                                 # global avg pool
    return h @ p["head_w"] + p["head_b"]


def resnet1d_family(cfg: ResNet1DConfig):
    """The family's cohort builder, ``(n_clients, *, device, generator)
    -> StackedCohort``."""
    def build(n_clients: int, *, device, generator=None) -> StackedCohort:
        params = init_resnet1d(Init(n_clients, device, generator), cfg)
        return StackedCohort("resnet", lambda p, x: apply_resnet1d(cfg, p, x),
                             params)
    return build
