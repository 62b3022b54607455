"""Public wrappers around the port's kernels, and their launch counts.

Each op runs its hand-written CUDA kernel for a CUDA tensor and its plain
PyTorch version (``repro_torch.kernels.ref``) for a CPU tensor; there is
no other route. ``wkv6_recurrence`` and ``flash_attention`` are
differentiable: their backward passes are kernels too (on the CPU, the
plain backward versions); under ``torch.func.vmap`` each folds the
vmapped axis into one launch. :func:`launch_counts` reads how many times each kernel
was launched, so a run can show that its main path went through them.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import cosine_sim as _cs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import weighted_agg as _wa
from repro_torch.kernels import wkv6 as _wkv
from repro_torch.kernels.cosine_sim import cosine_partials
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.weighted_agg import weighted_aggregate
from repro_torch.kernels.wkv6 import wkv6_recurrence


def combine_partials(dot: torch.Tensor, wsq: torch.Tensor,
                     gsq: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Eq. 2 from its partials: dot / max(‖w‖·‖gw‖, eps)."""
    return dot / torch.clamp(torch.sqrt(wsq) * torch.sqrt(gsq), min=eps)


def batched_cosine_similarity(W: torch.Tensor,
                              gw: torch.Tensor) -> torch.Tensor:
    """(N, D), (D,) → (N,) cosine similarities via the fused partials."""
    return combine_partials(*cosine_partials(W, gw))


def launch_counts() -> Dict[str, int]:
    """Calls that launched each kernel; a backward call launches its
    kernel pair once."""
    return {"cosine_partials": _cs.launches,
            "weighted_aggregate": _wa.launches,
            "wkv6": _wkv.launches,
            "flash_attention": _fa.launches,
            "wkv6_backward": _wkv.backward_launches,
            "flash_attention_backward": _fa.backward_launches}


def flash_launch_shapes() -> Dict[tuple, int]:
    """Forward flash launches by call: (B, Sq, Skv, Hq, Hk, hd, dtype
    name, causal, window) → count; they sum to
    ``launch_counts()["flash_attention"]``."""
    return dict(_fa.shape_launches)


def flash_backward_launch_shapes() -> Dict[tuple, int]:
    """Flash backward calls by call, keyed as :func:`flash_launch_shapes`;
    they sum to ``launch_counts()["flash_attention_backward"]``."""
    return dict(_fa.backward_shape_launches)


def reset_launch_counts() -> None:
    _cs.launches = 0
    _wa.launches = 0
    _wkv.launches = 0
    _fa.launches = 0
    _wkv.backward_launches = 0
    _fa.backward_launches = 0
    _fa.shape_launches.clear()
    _fa.backward_shape_launches.clear()


__all__ = ["batched_cosine_similarity", "combine_partials", "cosine_partials",
           "flash_attention", "flash_backward_launch_shapes",
           "flash_launch_shapes", "launch_counts",
           "reset_launch_counts", "weighted_aggregate", "wkv6_recurrence"]
