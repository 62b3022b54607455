"""Plain PyTorch versions of the ME kernels (the counterparts of
``repro.kernels.ref``).

The CPU tests hold them against the JAX oracles, the wrappers take them
for tensors on the CPU, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card. The main path never calls them for a CUDA
tensor.
"""

from __future__ import annotations

import torch


def cosine_similarity_ref(W: torch.Tensor, gw: torch.Tensor,
                          eps: float = 1e-12) -> torch.Tensor:
    """(N, D), (D,) → (N,) cosine similarities (paper Eq. 2)."""
    Wf = W.to(torch.float32)
    gf = gw.to(torch.float32)
    dots = Wf @ gf
    wn = torch.sqrt(torch.sum(Wf * Wf, dim=-1))
    gn = torch.sqrt(torch.sum(gf * gf))
    return dots / torch.clamp(wn * gn, min=eps)


def cosine_partials_ref(W: torch.Tensor, gw: torch.Tensor):
    """(N, D), (D,) → (dot (N,), wsq (N,), gsq ()) fused-pass partials."""
    Wf = W.to(torch.float32)
    gf = gw.to(torch.float32)
    return Wf @ gf, torch.sum(Wf * Wf, dim=-1), torch.sum(gf * gf)


def weighted_aggregate_ref(W: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """(N, D), (N,) → (D,) normalized weighted sum (paper Eq. 1)."""
    lam = weights.to(torch.float32)
    lam = lam / torch.sum(lam)
    return torch.einsum("n,nd->d", lam, W.to(torch.float32))
