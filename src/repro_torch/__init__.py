"""PyTorch port of the SQMD federation for one NVIDIA H100 (sm_90a).

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX. Server-side kernels are hand-written CUDA C++
(``repro_torch.kernels``); everything around them is plain PyTorch.

Entry points run on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda`` and raises when no card is present
instead of falling back.
"""
from __future__ import annotations

from typing import Union

import torch

Device = Union[None, str, torch.device]


def resolve_device(device: Device = None) -> torch.device:
    """``None`` means the card. A CUDA request without a card raises:
    nothing drops to the CPU unless the caller passed ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    return dev
