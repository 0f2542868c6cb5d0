"""Launch geometry of the hand kernels, decided in Python.

Every CUDA entry point of ``csrc/`` takes its grid, its block and its
dynamic shared memory from the caller and launches exactly that, after
checking that the grid covers its operands (a refusal comes back as
``cudaErrorInvalidConfiguration``). Beside each wrapper, one pure-Python
``*_args`` function decides a launch: the four ints (grid x, grid y,
threads a block, dynamic shared memory) the wrapper passes to the card.
Its ``*_geometry`` twin describes the same launch, built from those
ints, with what each grid axis covers, for the ``launch-geometry`` rule
(``repro_torch.analysis.launch_rules``) to check on odd shapes without a
card.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

# an H100 SXM: its SMs, and the dynamic shared memory a block may take
H100_SMS = 132
SMEM_PER_BLOCK = 227 * 1024
# a CUtensorMap's global strides must be multiples of this many bytes
TMA_STRIDE_ALIGN = 16


class Cover(NamedTuple):
    """One grid axis tiling one operand extent: ``tile`` elements a block
    and pass, ``passes`` grid-stride passes (1 unless the grid is
    persistent)."""
    operand: str
    axis: int
    tile: int
    extent: int
    passes: int = 1


class TensorMap(NamedTuple):
    """A TMA descriptor's global tensor: dims innermost first, strides in
    bytes of every dim but the innermost."""
    operand: str
    dims: Tuple[int, ...]
    strides: Tuple[int, ...]


class Geometry(NamedTuple):
    """One launch described: grid (x, y, z), block (x, y, z) threads,
    dynamic shared memory in bytes, and what each grid axis covers."""
    kernel: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    smem: int
    covers: Tuple[Cover, ...]
    tensor_maps: Tuple[TensorMap, ...] = ()


def blocks(extent: int, tile: int) -> int:
    """Blocks of ``tile`` that cover ``extent``."""
    return -(-extent // tile)


_SMS: Dict[int, int] = {}


def num_sms(device: torch.device) -> int:
    """The streaming multiprocessors of a card, read once a device."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]
