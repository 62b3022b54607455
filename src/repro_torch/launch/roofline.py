"""Roofline terms of a step on a mesh of H100s (port of
``repro.launch.roofline``).

Rates: the NVIDIA H100 SXM5 80GB data sheet's, per device. Compute at
the dense bf16 tensor-core peak (every model here computes in bf16),
memory at the HBM3 rate; the fp32 (non-tensor-core) peak is kept for the
kernels' bounds (``chip_smoke.py``).

Methodology:
* compute and memory terms: the analytic formulas of
  ``repro_torch.launch.costs`` over the whole step, divided by the
  device count;
* the collective term: none is recorded yet. The reference parses the
  compiled program's collectives out of XLA's HLO text; a torch step on
  a mesh has no such text. The step runs on a mesh as a DTensor program
  (``launch.specs``), so its collectives can be counted
  (``CommDebugMode``); scaling them by the layer count, as the reference
  scales by trip count, and the rate of each axis (NVLink or
  InfiniBand) are ROADMAP Queue 1 item 15, steps 5 and 6. Until then a
  row's ``collective_s`` is None, ``collective_note`` says why, and
  ``dominant`` is chosen between compute and memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# H100 SXM5 80GB data sheet, per device
H100_SXM5_BF16_DENSE_FLOP_PER_S = 989e12
H100_SXM5_FP32_FLOP_PER_S = 67e12
H100_SXM5_HBM3_BYTES_PER_S = 3.35e12

NO_COLLECTIVES = ("not recorded: the collective term waits for the "
                  "DTensor step's collectives scaled by the layer count "
                  "(ROADMAP Queue 1 item 15, step 5)")


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_global: float                 # analytic (costs.py)
    hbm_bytes_global: float             # analytic (costs.py)
    model_flops: float                  # 6·N·D (train) / 2·N·B (decode)
    n_devices: int
    arg_bytes_per_device: float = 0.0   # the abstract arguments' shards

    @property
    def compute_s(self) -> float:
        return self.flops_global / (self.n_devices
                                    * H100_SXM5_BF16_DENSE_FLOP_PER_S)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_global / (self.n_devices
                                        * H100_SXM5_HBM3_BYTES_PER_S)

    @property
    def collective_s(self) -> Optional[float]:
        """None: no collective is recorded (``NO_COLLECTIVES``)."""
        return None

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops_global if self.flops_global else 0.0

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s)

    def row(self) -> dict:
        """The reference's row keys; the collective ones and the XLA-only
        ones (its raw ``cost_analysis`` figures) null, and
        ``collective_note`` saying why the collective term is missing."""
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.flops_global,
            "useful_ratio": self.useful_flops_ratio,
            "collective_counts": None, "collective_bytes": None,
            "collective_note": NO_COLLECTIVES,
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
            arg_bytes_per_device: float) -> Roofline:
    return Roofline(arch, shape, mesh_name, analytic_flops, analytic_bytes,
                    model_flops, n_devices,
                    arg_bytes_per_device=arg_bytes_per_device)


__all__ = ["H100_SXM5_BF16_DENSE_FLOP_PER_S", "H100_SXM5_FP32_FLOP_PER_S",
           "H100_SXM5_HBM3_BYTES_PER_S", "NO_COLLECTIVES", "Roofline",
           "analyze", "model_flops_estimate"]
