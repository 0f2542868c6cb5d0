"""Roofline terms of a traced, DTensor-partitioned step: the counterpart
of the reference's ``launch/hlo_analysis.py``.

Per-device FLOPs, HBM bytes and collective bytes come from
``graph_cost.CostCounter`` (one rank's local ops and collectives), the
memory from its allocation log (``launch/dryrun.py``).

Hardware constants, one NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core
GPU datasheet, SXM5 column):

  * ``PEAK_FLOPS`` 989e12: dense BF16 Tensor Core FLOP/s (the datasheet's
    1,979 TFLOP/s is with 2:4 sparsity);
  * ``HBM_BW`` 3.35e12: HBM3 bytes/s;
  * ``NET_BW`` 50e9: bytes/s a GPU off its node. A 16-wide "model" axis
    spans two 8-GPU nodes, so a collective over it is held to one
    400 Gb/s NDR InfiniBand port a GPU (the DGX H100's ConnectX-7, one a
    GPU): 50 GB/s. NVLink inside a node (900 GB/s a GPU) is faster; one
    link figure is kept, as the reference keeps one, and the collective
    term is the slowest hop's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.launch.graph_cost import GraphCost

PEAK_FLOPS = 989e12          # dense bf16 FLOP/s, one H100 SXM5
HBM_BW = 3.35e12             # HBM3 bytes/s
NET_BW = 50e9                # bytes/s a GPU: one 400 Gb/s NDR port


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                 # per device
    hlo_bytes: float                 # per device
    coll_bytes: float                # per device, weighted
    model_flops: float               # 6*N*D analytic, whole step, all devices
    bytes_per_device: float          # from the traced memory
    coll_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    raw_cost_analysis: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    coll_bytes_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / NET_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (traced FLOPs * chips): remat and redundancy
        waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "hlo_flops_per_dev": self.hlo_flops,
            "hlo_bytes_per_dev": self.hlo_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
            "bytes_per_device": self.bytes_per_device,
            "coll_counts": self.coll_counts,
            "coll_bytes_by_kind": self.coll_bytes_by_kind,
            "raw_cost_analysis": self.raw_cost_analysis,
        }


def analyze_traced(cost: GraphCost, *, arch: str, shape: str,
                   mesh_name: str, chips: int, model_flops: float,
                   bytes_per_device: float) -> Roofline:
    """The roofline of one traced step (``analyze_compiled``'s
    counterpart). ``raw_cost_analysis`` keeps the counter's own totals
    (op count and raw collective bytes), there being no uncorrected
    compiler estimate to keep."""
    rl = Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=cost.flops, hlo_bytes=cost.hbm_bytes,
        coll_bytes=cost.coll_bytes, model_flops=model_flops,
        bytes_per_device=bytes_per_device,
        coll_counts=dict(cost.coll_counts))
    rl.raw_cost_analysis = {
        "flops": cost.flops, "bytes_accessed": cost.hbm_bytes,
        "n_ops": float(cost.n_ops),
        "coll_raw_bytes": float(sum(cost.coll_raw_bytes.values()))}
    rl.coll_bytes_by_kind = dict(cost.coll_bytes_by_kind)
    return rl


def model_flops_estimate(cfg, shape, kind: str) -> float:
    """6·N_active·D for train, 2·N_active·D for inference (whole step,
    all devices); D = the tokens processed this step."""
    n_active = cfg.active_params_per_token()
    if kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch       # decode: one token
