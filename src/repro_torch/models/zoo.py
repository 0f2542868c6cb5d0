"""The registered model zoo: architecture families as federation cohorts.

Clients of *different architectures* collaborate through messengers
alone; this module puts every family behind one registry (mirroring the
policy / codec / trigger registries):

  * ``@register_family(name)`` registers a builder
    ``(in_dim, n_classes) -> family`` plus a per-family default
    optimizer. A family is a cohort builder
    ``(n_clients, *, device, generator) -> module`` whose module stacks
    its clients on a leading axis and maps ``(n_c, B, ...)`` to
    ``(n_c, B, C)``;
  * ``build_zoo("mlp-s,resnet,transformer", in_dim, n_classes)`` resolves
    names into the ``{name: family}`` mapping both engines consume (a
    plain ``Mapping``), with the per-family optimizers riding along as
    ``zoo.optimizers``;
  * ``parse_assignment("mlp-s:0.5,resnet:0.3,transformer:0.2", ...)``
    turns a weighted spec (the paper's Table-I #ResNet8/20/50 ratios) or
    a plain round-robin list into the per-client family assignment.

Sequence families (transformer / ssm / rglru) see flat feature vectors
through a shared patch adapter: the ``in_dim`` features are zero-padded
to ``S * patch``, reshaped to ``(B, S, patch)`` tokens, linearly embedded
to ``d_model``, mixed, mean-pooled and classified. The ResNet-1D family
reads the raw series. The MLP tiers build the same ``CohortMLP`` as
``hetero_mlp_zoo``. Widths and optimizers are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.models.attention import attn_forward, init_attention
from repro_torch.models.common import (Init, ModelConfig, Params,
                                       StackedCohort, dense_init)
from repro_torch.models.mlp import MLPConfig, mlp_family
from repro_torch.models.resnet import ResNet1DConfig, resnet1d_family
from repro_torch.models.rglru import init_rglru, rglru_forward
from repro_torch.models.ssm import init_ssd, ssd_forward
from repro_torch.optim import Optimizer, adam, sgd

Family = Callable[..., torch.nn.Module]         # cohort builder
Builder = Callable[[int, int], Family]          # (in_dim, n_classes) -> family


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """One registered architecture family.

    ``tier`` is a human hint for which device class the family suits
    (wearable / phone / hospital server), documentation, not dispatch.
    ``make_optimizer`` returns a fresh per-cohort default optimizer; an
    explicit ``optimizer=`` at engine build time overrides it."""
    name: str
    builder: Builder
    make_optimizer: Callable[[], Optimizer]
    tier: str = ""


_FAMILIES: Dict[str, FamilySpec] = {}


def register_family(name: str, *, optimizer: Optional[Callable[[], Optimizer]]
                    = None, tier: str = ""):
    """Decorator registering ``(in_dim, n_classes) -> family``."""

    def deco(builder: Builder) -> Builder:
        if name in _FAMILIES:
            raise ValueError(f"family {name!r} already registered")
        make_opt = optimizer or (lambda: sgd(0.05, momentum=0.9))
        _FAMILIES[name] = FamilySpec(name, builder, make_opt, tier)
        return builder

    return deco


def registered_families() -> Tuple[str, ...]:
    return tuple(sorted(_FAMILIES))


def get_family(name: str) -> FamilySpec:
    try:
        return _FAMILIES[name]
    except KeyError:
        raise KeyError(f"unknown model family {name!r}; registered: "
                       f"{', '.join(registered_families())}") from None


def as_family(spec: Union[str, FamilySpec]) -> FamilySpec:
    """Coerce a family name or spec to the registered ``FamilySpec``."""
    if isinstance(spec, FamilySpec):
        return spec
    return get_family(spec)


# ---------------------------------------------------------------------------
# zoo construction
# ---------------------------------------------------------------------------

DEFAULT_ZOO = ("mlp-s", "mlp-m", "mlp-l")


class Zoo(dict):
    """``{family: cohort builder}`` in the order given, plus the
    per-family default optimizers (``self.optimizers``)."""

    def __init__(self):
        super().__init__()
        self.optimizers: Dict[str, Optimizer] = {}


def build_zoo(names: Union[None, str, Sequence[str]], in_dim: int,
              n_classes: int) -> Zoo:
    """Resolve family names into a ``Zoo``. ``names`` is a comma string,
    a sequence, or None (the default MLP tiers)."""
    if names is None:
        names = DEFAULT_ZOO
    elif isinstance(names, str):
        names = tuple(p.strip() for p in names.split(",") if p.strip())
    if not names:
        raise ValueError("zoo spec resolved to zero families")
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate families in zoo spec: {list(names)}")
    zoo = Zoo()
    for name in names:
        spec = get_family(name)
        zoo[name] = spec.builder(in_dim, n_classes)
        zoo.optimizers[name] = spec.make_optimizer()
    return zoo


def parse_assignment(spec: Union[None, str, Sequence[str]],
                     names: Sequence[str], n_clients: int) -> List[str]:
    """Per-client family assignment from a spec string.

    * ``None`` — round-robin over ``names`` (``names[i % len(names)]``);
    * ``"fam,fam,..."`` — round-robin over the listed families;
    * ``"fam:w,fam:w,..."`` — weighted shares, realized deterministically:
      client ``i`` goes to the family with the largest outstanding
      deficit ``w_f*(i+1) - count_f`` (first-listed wins ties), so
      prefixes are stable and every run of the same spec produces the
      same assignment;
    * a sequence — validated verbatim (must have ``n_clients`` entries).
    """
    names = list(names)
    if not names:
        raise ValueError("assignment needs at least one family")
    if spec is None:
        return [names[i % len(names)] for i in range(n_clients)]
    if not isinstance(spec, str):
        out = list(spec)
        if len(out) != n_clients:
            raise ValueError(f"assignment has {len(out)} entries for "
                             f"{n_clients} clients")
        unknown = sorted(set(out) - set(names))
        if unknown:
            raise ValueError(f"assignment names families not in the zoo: "
                             f"{unknown}; zoo has {names}")
        return out

    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if not parts:
        raise ValueError(f"empty assignment spec {spec!r}")
    weighted = any(":" in p for p in parts)
    fams: List[str] = []
    weights: List[float] = []
    for p in parts:
        fam, colon, w = p.partition(":")
        if weighted and not colon:
            raise ValueError(f"assignment spec mixes weighted and bare "
                             f"entries: {spec!r}")
        if fam not in names:
            raise ValueError(f"assignment names family {fam!r} not in the "
                             f"zoo; zoo has {names}")
        if weighted:
            if fam in fams:
                raise ValueError(f"family {fam!r} listed twice in weighted "
                                 f"spec {spec!r}")
            try:
                wf = float(w)
            except ValueError:
                raise ValueError(f"bad weight {w!r} for family {fam!r} in "
                                 f"{spec!r}") from None
            if wf <= 0:
                raise ValueError(f"weight for family {fam!r} must be > 0, "
                                 f"got {wf}")
            weights.append(wf)
        fams.append(fam)
    if not weighted:
        return [fams[i % len(fams)] for i in range(n_clients)]
    total = sum(weights)
    counts = [0] * len(fams)
    out = []
    for i in range(n_clients):
        deficits = [weights[f] * (i + 1) / total - counts[f]
                    for f in range(len(fams))]
        j = max(range(len(fams)), key=lambda f: (deficits[f], -f))
        counts[j] += 1
        out.append(fams[j])
    return out


# ---------------------------------------------------------------------------
# the MLP capacity tiers (the hetero_mlp_zoo configs)
# ---------------------------------------------------------------------------

_MLP_TIERS = {"mlp-s": (32,), "mlp-m": (64, 64), "mlp-l": (128, 128, 64)}


def _register_mlp(name: str, hidden: Tuple[int, ...], tier: str) -> None:
    @register_family(name, tier=tier)
    def _build(in_dim: int, n_classes: int) -> Family:
        return mlp_family(MLPConfig(name, in_dim, hidden, n_classes))


_register_mlp("mlp-s", _MLP_TIERS["mlp-s"], "wearable / sensor node")
_register_mlp("mlp-m", _MLP_TIERS["mlp-m"], "phone")
_register_mlp("mlp-l", _MLP_TIERS["mlp-l"], "bedside monitor")


# ---------------------------------------------------------------------------
# ResNet-1D (the paper's own client family)
# ---------------------------------------------------------------------------

@register_family("resnet", tier="bedside monitor")
def _build_resnet(in_dim: int, n_classes: int) -> Family:
    # width 8 keeps one client ~RESNET8/4 params
    return resnet1d_family(ResNet1DConfig("resnet8-1d-fed", (1, 1, 1), 8,
                                          False, n_classes=n_classes))


# ---------------------------------------------------------------------------
# sequence families: flat features -> (B, S, patch) tokens
# ---------------------------------------------------------------------------

_SEQ_LEN = 8          # fixed token count


def _n_patch(in_dim: int) -> int:
    return -(-in_dim // _SEQ_LEN)


def _to_tokens(x: torch.Tensor, n_patch: int) -> torch.Tensor:
    """(B, L) flat features -> (B, S, patch), zero-padded tail."""
    x = x.reshape(x.shape[0], -1)
    pad = _SEQ_LEN * n_patch - x.shape[1]
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(x.shape[0], _SEQ_LEN, n_patch)


def _seq_family(kind: str, cfg: ModelConfig, mixer_init, mixer_fn,
                in_dim: int, n_classes: int) -> Family:
    """Shared adapter: embed patch tokens, mix, mean-pool, classify."""
    patch = _n_patch(in_dim)
    d = cfg.d_model

    def init_params(init: Init) -> Params:
        p = {"embed_w": dense_init(init, (patch, d), fan_in=patch),
             "embed_b": init.full((d,), 0.0)}
        p.update({f"mixer/{k}": v for k, v in mixer_init(init, cfg).items()})
        p["head_w"] = dense_init(init, (d, n_classes), fan_in=d)
        p["head_b"] = init.full((n_classes,), 0.0)
        return p

    def apply_fn(p: Params, x: torch.Tensor) -> torch.Tensor:
        mixer = {k[len("mixer/"):]: v for k, v in p.items()
                 if k.startswith("mixer/")}
        h = _to_tokens(x, patch) @ p["embed_w"] + p["embed_b"]
        h = h + mixer_fn(mixer, cfg, h)
        h = torch.mean(h, dim=1)
        return h @ p["head_w"] + p["head_b"]

    def build(n_clients: int, *, device, generator=None) -> StackedCohort:
        return StackedCohort(kind, apply_fn,
                             init_params(Init(n_clients, device, generator)))

    return build


@register_family("transformer", optimizer=lambda: adam(3e-3),
                 tier="hospital server")
def _build_transformer(in_dim: int, n_classes: int) -> Family:
    cfg = ModelConfig("fed-transformer-t", "dense", n_layers=1, d_model=16,
                      n_heads=2, n_kv_heads=2, d_ff=0, vocab_size=0,
                      param_dtype=torch.float32)

    def mixer(p, c, h):
        positions = torch.arange(_SEQ_LEN, dtype=torch.int32,
                                 device=h.device)
        return attn_forward(p, c, h, positions)

    return _seq_family("transformer", cfg, init_attention, mixer, in_dim,
                       n_classes)


@register_family("ssm", optimizer=lambda: adam(3e-3), tier="phone")
def _build_ssm(in_dim: int, n_classes: int) -> Family:
    cfg = ModelConfig("fed-ssm-t", "ssm", n_layers=1, d_model=16, n_heads=1,
                      n_kv_heads=1, d_ff=0, vocab_size=0, ssm_state=4,
                      ssm_heads=2, ssm_expand=2, conv_width=2,
                      ssm_chunk=_SEQ_LEN, param_dtype=torch.float32)
    return _seq_family("ssm", cfg, init_ssd, ssd_forward, in_dim, n_classes)


@register_family("rglru", optimizer=lambda: adam(3e-3), tier="wearable")
def _build_rglru(in_dim: int, n_classes: int) -> Family:
    cfg = ModelConfig("fed-rglru-t", "hybrid", n_layers=1, d_model=16,
                      n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=0,
                      lru_width=16, conv_width=2, param_dtype=torch.float32)
    return _seq_family("rglru", cfg, init_rglru, rglru_forward, in_dim,
                       n_classes)
