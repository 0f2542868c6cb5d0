"""ResNet-1D 8/20/50 (the paper's client models, §IV-B: the 2D ResNets'
convolutions made 1D), plain, the clients of a cohort side by side.

CIFAR-style three stages of ``blocks`` blocks, channels ``width * 2^s``
(x4 with bottlenecks), stride 2 at the first block of stages 1 and 2;
"SAME" padding (``total = max((ceil(L/s) - 1) s + K - L, 0)``, half low,
the rest high); GroupNorm with one group (biased variance over channels
and positions, eps 1e-5) then a per-channel scale and bias; global mean
pool and a linear head. Convolutions N(0, 1/(K c_in)), head N(0,
1/c_in), norm scales 1, biases 0.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import operand


def _conv(name: str, k: int, c_in: int, c_out: int):
    return (name, (c_out, c_in, k), ("normal", 1.0 / math.sqrt(k * c_in)))


def _layout(fam: dict) -> Iterator[Tuple[str, int, int, int, bool]]:
    """(block prefix, c_in, c_out, stride, bottleneck) per block."""
    mult = 4 if fam["bottleneck"] else 1
    c_in = fam["width"]
    for stage, n_blocks in enumerate(fam["blocks"]):
        c_out = fam["width"] * (2 ** stage) * mult
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            yield f"stages/{stage}/{b}", c_in, c_out, stride, \
                fam["bottleneck"]
            c_in = c_out


def param_specs(fam: dict, in_dim: int, n_classes: int
                ) -> List[Tuple[str, tuple, tuple]]:
    w = fam["width"]
    one, zero = ("const", 1.0), ("const", 0.0)
    out = [_conv("stem", 3, 1, w), ("stem_s", (w,), one),
           ("stem_b", (w,), zero)]
    c_last = w
    for prefix, c_in, c_out, _, bottleneck in _layout(fam):
        p = lambda k: f"{prefix}/{k}"
        if bottleneck:
            mid = c_out // 4
            out += [_conv(p("w1"), 1, c_in, mid), _conv(p("w2"), 3, mid, mid),
                    _conv(p("w3"), 1, mid, c_out)]
            norms = [("1", mid), ("2", mid), ("3", c_out)]
        else:
            out += [_conv(p("w1"), 3, c_in, c_out),
                    _conv(p("w2"), 3, c_out, c_out)]
            norms = [("1", c_out), ("2", c_out)]
        for i, c in norms:
            out += [(p(f"s{i}"), (c,), one), (p(f"b{i}"), (c,), zero)]
        if c_in != c_out:
            out.append(_conv(p("w_skip"), 1, c_in, c_out))
        c_last = c_out
    out += [("head_w", (c_last, n_classes),
             ("normal", 1.0 / math.sqrt(c_last))),
            ("head_b", (n_classes,), zero)]
    return out


def _same(length: int, k: int, stride: int) -> Tuple[int, int]:
    total = max((-(-length // stride) - 1) * stride + k - length, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int,
         precision: str) -> torch.Tensor:
    """Every client's convolution as one product over its windows (no
    cuDNN, whose choice of algorithm sets its fp32 error): x (n_c, B,
    C_in, L), w (n_c, C_out, C_in, K) -> (n_c, B, C_out, L_out)."""
    k = w.shape[-1]
    x = F.pad(x, _same(x.shape[-1], k, stride))
    win = x.unfold(-1, k, stride)                     # (n, B, Cin, Lo, K)
    return torch.einsum("nbclk,nock->nbol", operand(win, precision),
                        operand(w, precision))


def norm(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (n_c, B, C, L); one group per sample, scale and bias (n_c, C)."""
    m = x.mean(dim=(2, 3), keepdim=True)
    v = ((x - m) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - m) / torch.sqrt(v + 1e-5) * s[:, None, :, None] \
        + b[:, None, :, None]


def forward(fam: dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
            precision: str = "fp32") -> torch.Tensor:
    """x (n_c, B, L) -> logits (n_c, B, C) for the stacked clients."""
    h = F.relu(norm(conv(x[:, :, None, :], p["stem"], 1, precision),
                    p["stem_s"], p["stem_b"]))
    for prefix, c_in, c_out, stride, bottleneck in _layout(fam):
        g = lambda k: p[f"{prefix}/{k}"]
        if c_in != c_out:
            skip = conv(h, g("w_skip"), stride, precision)
        else:
            skip = h[..., ::stride]
        if bottleneck:
            y = F.relu(norm(conv(h, g("w1"), 1, precision), g("s1"), g("b1")))
            y = F.relu(norm(conv(y, g("w2"), stride, precision), g("s2"),
                            g("b2")))
            y = norm(conv(y, g("w3"), 1, precision), g("s3"), g("b3"))
        else:
            y = F.relu(norm(conv(h, g("w1"), stride, precision), g("s1"),
                            g("b1")))
            y = norm(conv(y, g("w2"), 1, precision), g("s2"), g("b2"))
        h = F.relu(y + skip)
    pooled = h.mean(dim=3)                                  # (n_c, B, C)
    return torch.bmm(operand(pooled, precision),
                     operand(p["head_w"], precision)) + p["head_b"][:, None]


def _conv_flops(length: int, fam: dict, n_classes: int) -> List[int]:
    """2 x multiply-adds of each product of one sample's forward, the
    stem's first."""
    w = fam["width"]
    out = [2 * 1 * 3 * w * length]
    ln = length
    for _, c_in, c_out, stride, bottleneck in _layout(fam):
        lo = -(-ln // stride)
        if bottleneck:
            mid = c_out // 4
            out += [2 * c_in * mid * ln, 2 * mid * 3 * mid * lo,
                    2 * mid * c_out * lo]
        else:
            out += [2 * c_in * 3 * c_out * lo, 2 * c_out * 3 * c_out * lo]
        if c_in != c_out:
            out.append(2 * c_in * c_out * lo)
        ln = lo
    mult = 4 if fam["bottleneck"] else 1
    c_last = w * 2 ** (len(fam["blocks"]) - 1) * mult
    out.append(2 * c_last * n_classes)
    return out


def forward_flops(fam: dict, in_dim: int, n_classes: int,
                  length: int) -> int:
    return sum(_conv_flops(length, fam, n_classes))


def backward_flops(fam: dict, in_dim: int, n_classes: int,
                   length: int) -> int:
    """Every weight's gradient, and every input gradient but the stem's
    (the data needs none)."""
    layers = _conv_flops(length, fam, n_classes)
    return sum(layers) + sum(layers[1:])
