"""Messenger wire format — the encoded form messengers travel in.

This slice of the port carries the ``dense32`` codec only: fp32
pass-through, ``decode(encode(x))`` is ``x``. A ``Payload`` holds the
wire arrays and the logical decoded shape, so bytes are metered on what
the link carried.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

_DOMAINS = ("log", "prob")


@dataclasses.dataclass
class Payload:
    """One encoded messenger batch: wire arrays + routing metadata."""
    codec: str
    domain: str
    shape: Tuple[int, ...]
    arrays: Dict[str, torch.Tensor]

    @property
    def rows(self) -> int:
        """Number of messengers in the batch (product of leading dims)."""
        n = 1
        for d in self.shape[:-2]:
            n *= int(d)
        return n


def _check_codec(codec: str) -> None:
    if codec != "dense32":
        raise KeyError(f"unknown codec {codec!r}; this port has: dense32")


def encode(codec: str, x: torch.Tensor, domain: str = "log") -> Payload:
    """``x (..., R, C)`` soft decisions -> wire Payload."""
    _check_codec(codec)
    if domain not in _DOMAINS:
        raise ValueError(f"domain must be one of {_DOMAINS}, got {domain!r}")
    x = x.float()
    return Payload("dense32", domain, tuple(x.shape), {"data": x})


def decode(payload: Payload) -> torch.Tensor:
    _check_codec(payload.codec)
    return payload.arrays["data"]


def payload_bytes(payload: Payload) -> int:
    """Wire bytes of the whole payload (fields at their wire dtypes)."""
    return int(sum(a.numel() * a.element_size()
                   for a in payload.arrays.values()))


def bytes_per_messenger(payload: Payload) -> float:
    return payload_bytes(payload) / max(payload.rows, 1)


def gather(payload: Payload, rows) -> Payload:
    """Slice a batched payload down to the given leading-axis rows."""
    if len(payload.shape) < 3:
        raise ValueError(f"gather needs a batched (N, R, C) payload, got "
                         f"shape {payload.shape}")
    first = next(iter(payload.arrays.values()))
    idx = torch.as_tensor(rows, dtype=torch.long, device=first.device)
    return Payload(payload.codec, payload.domain,
                   (int(idx.shape[0]),) + tuple(payload.shape[1:]),
                   {k: a[idx] for k, a in payload.arrays.items()})


def assemble(parts: Sequence[Payload], rows: Sequence, n: int) -> Payload:
    """Scatter per-cohort payloads into one N-stack payload; rows no part
    owns stay zero (they are masked out of the merge on ingest)."""
    if not parts:
        raise ValueError("assemble needs at least one part")
    first = parts[0]
    for p in parts[1:]:
        if p.codec != first.codec or p.domain != first.domain or \
                p.shape[1:] != first.shape[1:]:
            raise ValueError("assemble: parts disagree on codec/shape")
    base = {k: a.new_zeros((n,) + tuple(a.shape[1:]))
            for k, a in first.arrays.items()}
    for part, ids in zip(parts, rows):
        for k in base:
            idx = torch.as_tensor(ids, dtype=torch.long,
                                  device=base[k].device)
            base[k][idx] = part.arrays[k]
    return Payload(first.codec, first.domain, (n,) + tuple(first.shape[1:]),
                   base)
