"""Launch auditor: every hand kernel's geometry must cover its operands.

The reference intercepts ``pallas_call`` and checks that each block shape
divides its operand. A CUDA kernel instead masks its ragged edge, so the
port checks what a grid can get wrong there: each hand kernel's launch
comes from one pure-Python ``*_args`` function beside its wrapper
(``repro_torch.kernels``), which the wrapper passes to the card and the
entry point launches as given; its ``*_geometry`` twin describes that
launch for this rule. On odd probe shapes, no extent a multiple
of any tile, the rule holds each geometry to four things:

  * grid x tile (x grid-stride passes) covers every extent,
  * no block lies wholly outside every extent (an idle block on the
    first pass is a grid sized for the wrong operand),
  * dynamic shared memory fits the 227 KB a block may take, and the
    block and grid fit the card's limits,
  * every global stride of a ``CUtensorMap`` operand (the 3xTF32 GEMM's
    planes, the grouped product's Hopper routes' operands and planes) is
    a multiple of 16 bytes.

The geometry is pure Python, so the rule runs on the CPU. ``chip_smoke``
launches each kernel at the same probe shapes on the card and holds it
against its plain version.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

from repro_torch.analysis.registry import (AnalysisContext, Violation,
                                           register_rule)
from repro_torch.kernels.geometry import (H100_SMS, SMEM_PER_BLOCK,
                                          TMA_STRIDE_ALIGN, Geometry)

# odd probe shapes: rows of the two operands, R and C (K = 21, no tile's
# multiple), neighbor slots, thin rows (every thin instance 1..16), the
# thin kernel's many side (one pass, and past the resident-grid cap), and
# the resident blocks an SM the occupancy calculator may report
PROBE_U, PROBE_M = 131, 257
PROBE_R, PROBE_C = 3, 7
PROBE_SLOTS = (5, 4096)
PROBE_THIN = (1, 2, 3, 5, 9, 13, 16)
PROBE_MANY = (1031, 100_003)
PROBE_BLOCKS_PER_SM = (1, 8)
# the grouped product's group counts: one, a few, deepseek-v2-236b's 160;
# its Hopper routes' widths, K and N multiples of 8 as the bf16 route
# takes them (and of 4, as the fp32 one does) but of no tile (64 or 32
# deep, 128 x 256 or 128 x 128)
PROBE_GROUPS = (1, 7, 160)
PROBE_TMA_K, PROBE_TMA_N = 24, 136

MAX_THREADS = 1024
MAX_GRID_YZ = 65535


def probe_geometries(sms: int = H100_SMS) -> List[Tuple[str, Geometry]]:
    """(label, geometry) of every hand kernel's launch at the probe
    shapes, built from the ``*_args`` the wrappers launch with."""
    from repro_torch.kernels import dequant_kl as dk
    from repro_torch.kernels import neighbor_gather as ng
    from repro_torch.kernels import neighbor_mean as nm
    from repro_torch.kernels import pairwise_kl as pk
    from repro_torch.kernels import ragged_dot as rd
    from repro_torch.kernels import soft_ce as sc
    u, m, r, c = PROBE_U, PROBE_M, PROBE_R, PROBE_C
    k = r * c
    k_pad = -(-k // pk.BK) * pk.BK
    n_pad = -(-u // pk.BK) * pk.BK
    out = [
        (f"rows={u}", pk.split_geometry(u)),
        (f"U={u},M={m}", pk.gemm_geometry(u, m, k_pad)),
        # the dense Eq. 5 route: W's split over (N, N), S's transposing
        # split, the plain-store GEMM of (N, Kp) by (RC, Kp)
        (f"W rows={u}", pk.split_geometry(u)),
        (f"N={u},RC={k}", nm.split_geometry(k, n_pad)),
        (f"N={u},RC={k}", pk.gemm_geometry(u, k, n_pad)),
        (f"N={u}", sc.launch_geometry(u)),
        (f"rows={u}", dk.split_geometry(u)),
    ]
    out += [(f"N={u},K={slots}", ng.launch_geometry(u, slots))
            for slots in PROBE_SLOTS]
    # the grouped product: M rows by K = R*C into N = U columns (and the
    # input gradient back, N into K), its weight gradient (G, K, N); fp32
    # and bf16 rings
    for g in PROBE_GROUPS:
        for elem in (4, 2):
            out += [(f"M={m},N={u},G={g},{elem}B",
                     rd.launch_geometry(m, u, g, elem, False)),
                    (f"M={m},N={k},G={g},{elem}B",
                     rd.launch_geometry(m, k, g, elem, True)),
                    (f"K={k},N={u},G={g},{elem}B",
                     rd.wgrad_geometry(k, u, g, elem))]
    # its Hopper route (bf16, K and N multiples of 8): the persistent grid
    # over the tiles' bound, one pass and (160 groups) several, and its
    # tensor maps' strides
    tk, tn = PROBE_TMA_K, PROBE_TMA_N
    for g in PROBE_GROUPS:
        out += [(f"M={m},K={tk},N={tn},G={g}",
                 rd.tma_geometry(m, tk, tn, g, False, sms)),
                (f"M={m},K={tn},N={tk},G={g},rhs^T",
                 rd.tma_geometry(m, tn, tk, g, True, sms)),
                (f"M={m},K={tk},N={tn},G={g}",
                 rd.tma_wgrad_geometry(m, tk, tn, g, sms))]
    # its fp32 Hopper route at the same widths (multiples of 4, as that
    # route takes them): the two products and the weight gradient's
    # transposing split (the forward's split is B1's, probed above)
    for g in PROBE_GROUPS:
        out += [(f"M={m},K={tk},N={tn},G={g}",
                 rd.tf32_geometry(m, tk, tn, g, False, sms)),
                (f"M={m},K={tn},N={tk},G={g},rhs^T",
                 rd.tf32_geometry(m, tn, tk, g, True, sms)),
                (f"M={m},K={tk},N={tn},G={g}",
                 rd.tf32_wgrad_split_geometry(m, tk, tn, g)),
                (f"M={m},K={tk},N={tn},G={g}",
                 rd.tf32_wgrad_geometry(m, tk, tn, g, sms))]
    for t in PROBE_THIN:
        for many in PROBE_MANY:
            for per_sm in PROBE_BLOCKS_PER_SM:
                for have_lt in (False, True):
                    out.append((f"T={t},M={many},blocks/SM={per_sm},"
                                f"lt={int(have_lt)}",
                                dk.thin_geometry(t, many, r, c, have_lt, sms,
                                                 per_sm)))
    return out


def check_geometry(label: str, geo: Geometry,
                   rule: str = "launch-geometry") -> List[Violation]:
    """The four checks of the module docstring on one launch."""
    where = f"{geo.kernel}[{label}]"
    out = []
    if any(g < 1 for g in geo.grid) or max(geo.grid[1:]) > MAX_GRID_YZ:
        out.append(Violation(rule, f"{where}#grid",
                             f"grid {geo.grid} outside 1..{MAX_GRID_YZ} "
                             f"(y, z)"))
    threads = geo.block[0] * geo.block[1] * geo.block[2]
    if not 1 <= threads <= MAX_THREADS:
        out.append(Violation(rule, f"{where}#block",
                             f"{threads} threads a block (at most "
                             f"{MAX_THREADS})"))
    for cov in geo.covers:
        g = geo.grid[cov.axis]
        if g * cov.tile * cov.passes < cov.extent:
            out.append(Violation(
                rule, f"{where}#{cov.operand}",
                f"grid axis {cov.axis}: {g} blocks x {cov.tile} x "
                f"{cov.passes} pass(es) = {g * cov.tile * cov.passes} < "
                f"extent {cov.extent}: the ragged edge is never computed"))
        elif (g - 1) * cov.tile >= cov.extent:
            out.append(Violation(
                rule, f"{where}#{cov.operand}",
                f"grid axis {cov.axis}: block {g - 1} starts at "
                f"{(g - 1) * cov.tile}, past extent {cov.extent}: a block "
                f"wholly outside its operand"))
    if geo.smem > SMEM_PER_BLOCK:
        out.append(Violation(rule, f"{where}#smem",
                             f"{geo.smem} bytes of dynamic shared memory, "
                             f"more than the {SMEM_PER_BLOCK} a block may "
                             f"take"))
    for tm in geo.tensor_maps:
        bad = [s for s in tm.strides if s % TMA_STRIDE_ALIGN]
        if bad:
            out.append(Violation(
                rule, f"{where}#{tm.operand}",
                f"CUtensorMap {tm.operand} (dims {tm.dims}) has global "
                f"strides {tm.strides} bytes; TMA needs multiples of "
                f"{TMA_STRIDE_ALIGN}"))
    return out


@register_rule("launch-geometry", family="launch")
def launch_geometry(ctx: AnalysisContext) -> Iterable[Violation]:
    """Every hand kernel's launch geometry covers its operands.

    At odd probe shapes: no idle block, shared memory within a block's,
    TMA strides 16-byte aligned."""
    for label, geo in probe_geometries():
        yield from check_geometry(label, geo)
