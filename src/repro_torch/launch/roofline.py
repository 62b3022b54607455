"""Roofline terms of a step on a mesh of H100s (port of
``repro.launch.roofline``).

Rates, per device: the NVIDIA H100 SXM5 80GB data sheet's dense bf16
tensor-core peak (every model here computes in bf16) and HBM3 rate (the
fp32 peak, outside the tensor cores, is kept for the kernels' bounds,
``chip_smoke.py``); its NVLink 4 rate, 900 GB/s a GPU both ways, 450
GB/s each way, among the 8 GPUs of a node (HGX H100 8-GPU); and
InfiniBand NDR, 400 Gb/s a port, 50 GB/s each way, with one ConnectX-7
NIC a GPU (DGX H100), between nodes. The reference's single ``ICI_BW``
becomes a rate for each mesh axis: an axis whose every group lies inside
one node of 8 GPUs (ranks ``8k .. 8k + 7``) runs at the NVLink rate,
any other at the InfiniBand rate, since a ring runs at its slowest link.

Methodology:
* compute and memory terms: the analytic formulas of
  ``repro_torch.launch.costs`` over the whole step, divided by the
  device count;
* the collective term: each device's collective operand bytes by mesh
  axis, from the step's planned collectives
  (``launch.collectives.count_collectives``: the DTensor program run on
  meta tensors at two cut depths and extrapolated to the full depth, as
  the reference scales by trip count), each axis's bytes over its link
  rate, summed over the axes. A row says which link each axis got
  (``collective_axes``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

from repro_torch.launch.collectives import (OTHER_AXIS, CollectiveStats,
                                            axis_ranks)

# H100 SXM5 80GB data sheet, per device
H100_SXM5_BF16_DENSE_FLOP_PER_S = 989e12
H100_SXM5_FP32_FLOP_PER_S = 67e12
H100_SXM5_HBM3_BYTES_PER_S = 3.35e12
# the same data sheet: NVLink 4, 900 GB/s a GPU both ways; each way
H100_SXM5_NVLINK_BYTES_PER_S = 450e9
# InfiniBand NDR, 400 Gb/s a port, one NIC a GPU (DGX H100); each way
INFINIBAND_NDR_BYTES_PER_S = 50e9
GPUS_PER_NODE = 8                   # HGX H100 8-GPU
LINK_RATES = {"nvlink": H100_SXM5_NVLINK_BYTES_PER_S,
              "infiniband": INFINIBAND_NDR_BYTES_PER_S}


def axis_links(mesh) -> Dict[str, str]:
    """Each axis of ``mesh`` (and each join of axes,
    ``collectives.axis_ranks``): "nvlink" if every group along it lies
    inside one node of ``GPUS_PER_NODE`` ranks, else "infiniband"."""
    ranks = mesh.mesh
    names = tuple(mesh.mesh_dim_names)
    out = {}
    for axis in axis_ranks(mesh):
        dims = [names.index(a) for a in axis.split("+")]
        rest = [d for d in range(len(names)) if d not in dims]
        groups = ranks.permute(*rest, *dims).reshape(
            -1, math.prod(ranks.shape[d] for d in dims))
        nodes = groups // GPUS_PER_NODE
        inside = bool((nodes == nodes[:, :1]).all())
        out[axis] = "nvlink" if inside else "infiniband"
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_global: float                 # analytic (costs.py)
    hbm_bytes_global: float             # analytic (costs.py)
    collectives: CollectiveStats        # planned, depth-extrapolated
    model_flops: float                  # 6·N·D (train) / 2·N·B (decode)
    n_devices: int
    arg_bytes_per_device: float = 0.0   # the abstract arguments' shards
    links: Dict[str, str] = field(default_factory=dict)   # axis → link

    @property
    def compute_s(self) -> float:
        return self.flops_global / (self.n_devices
                                    * H100_SXM5_BF16_DENSE_FLOP_PER_S)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_global / (self.n_devices
                                        * H100_SXM5_HBM3_BYTES_PER_S)

    def link(self, axis: str) -> str:
        """The link an axis runs at; a group that is no single axis
        (``OTHER_AXIS``) at InfiniBand's."""
        return self.links.get(axis, "infiniband") if axis != OTHER_AXIS \
            else "infiniband"

    @property
    def collective_s(self) -> float:
        # in the axes' order, as ``row`` lists them: the same bytes by
        # axis give the same term, bit for bit
        return sum(b / LINK_RATES[self.link(axis)] for axis, b in
                   sorted(self.collectives.bytes_by_axis.items()))

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops_global if self.flops_global else 0.0

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> dict:
        """The reference's row keys, the XLA-only ones (its raw
        ``cost_analysis`` figures) null; ``collective_axes`` says each
        axis's bytes a device, its link and the link's rate."""
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.flops_global,
            "useful_ratio": self.useful_flops_ratio,
            "collective_counts": dict(self.collectives.count_by_kind),
            "collective_bytes": dict(self.collectives.bytes_by_kind),
            "collective_axes": {
                axis: {"bytes": b, "link": self.link(axis),
                       "bytes_per_s": LINK_RATES[self.link(axis)]}
                for axis, b in sorted(
                    self.collectives.bytes_by_axis.items())},
            "raw_cost_flops_per_dev": None, "raw_cost_bytes_per_dev": None,
            "arg_gb_per_dev": self.arg_bytes_per_device / 1e9,
        }


def model_flops_estimate(n_params_active: int, shape_kind: str,
                         global_batch: int, seq_len: int) -> float:
    """MODEL_FLOPS: 6·N·tokens for training, 2·N·tokens for prefill,
    2·N·batch per decoded token."""
    if shape_kind == "train":
        return 6.0 * n_params_active * global_batch * seq_len
    if shape_kind == "prefill":
        return 2.0 * n_params_active * global_batch * seq_len
    return 2.0 * n_params_active * global_batch


def analyze(*, arch: str, shape: str, mesh_name: str, n_devices: int,
            model_flops: float, analytic_flops: float, analytic_bytes: float,
            arg_bytes_per_device: float, collectives: CollectiveStats,
            links: Dict[str, str]) -> Roofline:
    return Roofline(arch, shape, mesh_name, analytic_flops, analytic_bytes,
                    collectives, model_flops, n_devices,
                    arg_bytes_per_device=arg_bytes_per_device, links=links)


__all__ = ["GPUS_PER_NODE", "H100_SXM5_BF16_DENSE_FLOP_PER_S",
           "H100_SXM5_FP32_FLOP_PER_S", "H100_SXM5_HBM3_BYTES_PER_S",
           "H100_SXM5_NVLINK_BYTES_PER_S", "INFINIBAND_NDR_BYTES_PER_S",
           "LINK_RATES", "Roofline", "analyze", "axis_links",
           "model_flops_estimate"]
