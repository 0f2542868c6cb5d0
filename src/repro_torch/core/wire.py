"""Messenger wire codecs — the encoded form messengers travel in.

A codec turns a stack of soft decisions ``(..., R, C)`` into a
``Payload`` (wire-dtype tensors plus the logical decoded shape) and back:

    encode(codec, x, domain) -> Payload   # what the client transmits
    decode(payload)          -> x_hat     # what the server reconstructs
    payload_bytes(payload)   -> int       # what the link carried

Codecs are registered by name (``@register_codec``) and reachable from
``FederationConfig(uplink=..., downlink=...)`` and the ``federate`` CLI.
This port carries:

  dense32   fp32 pass-through — the bit-identical oracle (default)
  dense16   bf16 cast, 2x
  int8      per-row affine quantization: uint8 codes + per-row bf16
            scale / zero point (the row minimum), C + 4 bytes a row
  topk      top-k probabilities per reference sample (bf16 values +
            int16 class ids) + a renormalized bf16 tail mass

dense32, dense16 and int8 encode byte for byte as the reference does.
topk does too in the prob domain; in the log domain its exp is fp64
rounded once to fp32, the same bits on the CPU and the card, where the
reference's is its backend's own fp32 exp.

``domain`` records what the values are: messenger LOG-probabilities
(``"log"``, the uplink) or probability targets (``"prob"``, the
downlink). A lossy decode renormalizes in its domain.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Dict, Sequence, Tuple, Type, Union

import torch

from repro_torch import trace
from repro_torch.kernels import ops

_DOMAINS = ("log", "prob")
_PROB_FLOOR = 1e-10   # decode floor before a renorm: keeps KL terms finite


@dataclasses.dataclass
class Payload:
    """One encoded messenger batch: wire tensors + routing metadata."""
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


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_CODECS: Dict[str, Type["Codec"]] = {}


def register_codec(name: str):
    """Class decorator binding ``cls.name`` and making the codec reachable
    by name (config, CLI)."""

    def deco(cls: Type["Codec"]) -> Type["Codec"]:
        if name in _CODECS:
            raise ValueError(f"codec {name!r} already registered")
        cls.name = name
        _CODECS[name] = cls
        return cls

    return deco


def registered_codecs() -> Tuple[str, ...]:
    return tuple(sorted(_CODECS))


def get_codec(name: str) -> Type["Codec"]:
    try:
        return _CODECS[name]
    except KeyError:
        raise KeyError(f"unknown codec {name!r}; registered: "
                       f"{registered_codecs()}") from None


def as_codec(spec: Union[None, str, "Codec"]) -> "Codec":
    """Coerce None / name / instance into a Codec (None is dense32). A
    ``name:arg`` spec passes ``arg`` to the codec."""
    if isinstance(spec, Codec):
        return spec
    if spec is None:
        return get_codec("dense32")()
    name, _, arg = spec.partition(":")
    return get_codec(name).from_arg(arg)


# --------------------------------------------------------------------------
# codec interface
# --------------------------------------------------------------------------

class Codec(abc.ABC):
    """A messenger wire format: a small frozen config holder."""

    name: str = "?"

    @classmethod
    def from_arg(cls, arg: str) -> "Codec":
        if arg:
            raise ValueError(f"codec {cls.name!r} takes no argument "
                             f"(got {arg!r})")
        return cls()

    @abc.abstractmethod
    def encode(self, x: torch.Tensor, domain: str = "log") -> Payload:
        """``x (..., R, C)`` soft decisions -> wire Payload."""

    @abc.abstractmethod
    def decode(self, payload: Payload) -> torch.Tensor:
        """Payload -> ``(..., R, C)`` fp32 reconstruction."""

    def payload_bytes(self, payload: Payload) -> int:
        """Wire bytes of the whole payload (fields at their wire dtypes)."""
        return int(sum(a.numel() * a.element_size()
                       for a in payload.arrays.values()))

    def _check(self, domain: str) -> None:
        if domain not in _DOMAINS:
            raise ValueError(f"domain must be one of {_DOMAINS}, "
                             f"got {domain!r}")

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


def encode(codec: Union[None, str, Codec], x: torch.Tensor,
           domain: str = "log") -> Payload:
    return as_codec(codec).encode(x, domain=domain)


def decode(payload: Payload) -> torch.Tensor:
    """Dispatch on the payload's own codec name."""
    return get_codec(payload.codec)().decode(payload)


def payload_bytes(payload: Payload) -> int:
    return get_codec(payload.codec)().payload_bytes(payload)


def bytes_per_messenger(payload: Payload) -> float:
    return payload_bytes(payload) / max(payload.rows, 1)


def gather(payload: Payload, rows) -> Payload:
    """Slice a batched payload down to the given leading-axis rows (every
    codec is row-independent, so ``decode(gather(p, rows))`` is
    ``decode(p)[rows]``)."""
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
    dev = next(iter(base.values())).device
    for part, ids in zip(parts, rows):
        with trace.sync("upload.ids"):
            idx = torch.as_tensor(ids, dtype=torch.long, device=dev)
        for k in base:
            base[k][idx] = part.arrays[k]
    return Payload(first.codec, first.domain, (n,) + tuple(first.shape[1:]),
                   base)


# --------------------------------------------------------------------------
# built-in codecs
# --------------------------------------------------------------------------

@register_codec("dense32")
@dataclasses.dataclass(frozen=True)
class Dense32(Codec):
    """fp32 pass-through: decode(encode(x)) IS x for fp32 input."""

    def encode(self, x: torch.Tensor, domain: str = "log") -> Payload:
        self._check(domain)
        x = x.float()
        return Payload("dense32", domain, tuple(x.shape), {"data": x})

    def decode(self, payload: Payload) -> torch.Tensor:
        return payload.arrays["data"]


@register_codec("dense16")
@dataclasses.dataclass(frozen=True)
class Dense16(Codec):
    """bf16 cast (round to nearest even, as the reference's). Lossy:
    decode renormalizes in its domain."""

    def encode(self, x: torch.Tensor, domain: str = "log") -> Payload:
        self._check(domain)
        return Payload("dense16", domain, tuple(x.shape),
                       {"data": x.to(torch.bfloat16)})

    def decode(self, payload: Payload) -> torch.Tensor:
        x = payload.arrays["data"].float()
        if payload.domain == "log":
            return torch.log_softmax(x, dim=-1)
        return _renorm_probs(x)


def quantize_int8(x: torch.Tensor):
    """(..., C) fp32 -> (q uint8, scale bf16, zp bf16), per row.

    Quantizes against the bf16-ROUNDED scale and zero point — the values
    the decoder reads off the wire — in the reference's order:
    ``(x − zp) / scale``, round half to even, clip to [0, 255]. The scale
    ``(hi − lo)/255`` is floored at 1e-8 before its bf16 cast."""
    x = x.float()
    lo = x.amin(dim=-1)
    hi = x.amax(dim=-1)
    scale = torch.clamp((hi - lo) / 255.0, min=1e-8).to(torch.bfloat16)
    zp = lo.to(torch.bfloat16)
    q = torch.clamp(torch.round((x - zp.float()[..., None])
                                / scale.float()[..., None]),
                    0.0, 255.0).to(torch.uint8)
    return q, scale, zp


@register_codec("int8")
@dataclasses.dataclass(frozen=True)
class Int8(Codec):
    """Per-row affine quantization (one row = one reference sample):
    uint8 codes with a per-row bf16 scale and zero point (the row
    minimum). Decode dequantizes and renormalizes in its domain; the bf16
    rounding of the zero point is a per-row shift the log-domain softmax
    cancels."""

    def encode(self, x: torch.Tensor, domain: str = "log") -> Payload:
        self._check(domain)
        q, scale, zp = quantize_int8(x)
        return Payload("int8", domain, tuple(x.shape),
                       {"q": q, "scale": scale, "zp": zp})

    def decode(self, payload: Payload) -> torch.Tensor:
        deq = (payload.arrays["q"].float()
               * payload.arrays["scale"].float()[..., None]
               + payload.arrays["zp"].float()[..., None])
        if payload.domain == "log":
            return torch.log_softmax(deq, dim=-1)
        return _renorm_probs(deq)

    def pairwise_kl(self, payload: Payload) -> torch.Tensor:
        """Eq. 2 divergence matrix straight off the wire form, through the
        fused dequant -> KL kernel (``kernels/dequant_kl.py``): the fp32
        (N, R, C) decode is never materialized."""
        if payload.domain != "log":
            raise ValueError("pairwise_kl grades log-domain messengers")
        if len(payload.shape) != 3:
            raise ValueError(f"expected an (N, R, C) repository payload, "
                             f"got shape {payload.shape}")
        return ops.int8_pairwise_kl(payload.arrays["q"],
                                    payload.arrays["scale"],
                                    payload.arrays["zp"])


@register_codec("topk")
@dataclasses.dataclass(frozen=True)
class TopK(Codec):
    """Soft-label sparsification: keep the ``k`` largest probabilities
    per reference sample (bf16 values + int16 class ids, int32 past
    C = 32767) plus one bf16 tail mass, spread uniformly over the unsent
    classes on decode. Ties keep the lowest class index first, as
    ``jax.lax.top_k`` does (a stable descending sort)."""

    k: int = 8

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"topk k must be >= 1, got {self.k}")

    @classmethod
    def from_arg(cls, arg: str) -> "TopK":
        return cls(k=int(arg)) if arg else cls()

    def encode(self, x: torch.Tensor, domain: str = "log") -> Payload:
        self._check(domain)
        x = x.float()
        c = x.shape[-1]
        # fp64 exp rounded once: the same bits on any device
        p = torch.exp(x.double()).float() if domain == "log" else x
        k = min(self.k, c)
        vals, idx = torch.sort(p, dim=-1, descending=True, stable=True)
        vals, idx = vals[..., :k], idx[..., :k]
        # the tail of a near-complete top k is a rounding residue, so its
        # summation order shows in the decoded unsent classes: sum in the
        # reference's order, the same on any device
        tail = torch.clamp(1.0 - _xla_row_sum(vals), 0.0, 1.0)
        idt = torch.int16 if c <= torch.iinfo(torch.int16).max \
            else torch.int32
        return Payload("topk", domain, tuple(x.shape),
                       {"idx": idx.to(idt), "vals": vals.to(torch.bfloat16),
                        "tail": tail.to(torch.bfloat16)})

    def decode(self, payload: Payload) -> torch.Tensor:
        shape = tuple(payload.shape)
        c = shape[-1]
        idx = payload.arrays["idx"].long()
        vals = payload.arrays["vals"].float()
        tail = payload.arrays["tail"].float()
        k = idx.shape[-1]
        base = tail / max(c - k, 1) if k < c else torch.zeros_like(tail)
        p = base[..., None].expand(shape).clone()
        p.scatter_(-1, idx, vals)
        p = _renorm_probs(p)
        if payload.domain == "log":
            return torch.log(p)
        return p


def _xla_row_sum(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """fp32 sum over the last axis in the order XLA's CPU backend uses:
    rows of up to ``window`` left to right; a longer row zero-padded to a
    multiple of ``window`` (half the padding, rounded down, in front),
    each window summed left to right, then the window sums reduced the
    same way."""
    n = x.shape[-1]
    if n > window:
        pad = -n % window
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(*x.shape[:-1], -1, window)
    total = x[..., 0]
    for j in range(1, x.shape[-1]):
        total = total + x[..., j]
    return _xla_row_sum(total, window) if n > window else total


def _renorm_probs(x: torch.Tensor) -> torch.Tensor:
    """Clip to the simplex floor and renormalize rows to sum 1."""
    p = torch.clamp(x, min=_PROB_FLOOR)
    return p / p.sum(dim=-1, keepdim=True)
