"""fp32 with TF32 off, or the TF32 control."""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("fp32", "tf32", "fp64")   # fp64: a witness of fp32's error


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32's 10 mantissa bits, to nearest (ties
    away from zero), on the bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def flags(precision: str):
    """torch's TF32 switches for ``precision``, restored after."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    on = precision == "tf32"
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "fp64" else torch.float32


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's operand as ``precision`` reads it. The rounding is
    differentiable as the identity, so gradients flow through it."""
    if precision != "tf32":
        return x
    return x + (tf32_round(x) - x).detach()
