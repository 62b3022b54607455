"""Shared building blocks of the LM families (port of
``repro.models.layers``), so far only the part RWKV-6 needs: the compute
dtype, the two initializers and RMSNorm. Attention, RoPE and the MLPs
come with the transformer slice.

Weights are plain tensors in nested dicts, as in the reference.
``jax.random`` draws cannot be reproduced in torch: the initializers
draw from a ``torch.Generator`` on the device they fill, and parity
tests load the reference's weights instead.
"""

from __future__ import annotations

import math

import torch

COMPUTE_DTYPE = torch.bfloat16


# Φ(-2) and Φ(2): the standard normal's CDF at the truncation bounds
_CDF_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_CDF_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def truncated_normal(generator: torch.Generator,
                     shape: tuple) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], float32, drawn on
    ``generator.device`` by inverting the CDF of a uniform draw."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    x = torch.erfinv(2.0 * (_CDF_LO + (_CDF_HI - _CDF_LO) * u) - 1.0)
    return torch.clamp(x * math.sqrt(2.0), -2.0, 2.0)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(d_in, d_out) truncated normal in [-2, 2] scaled by 1/√d_in."""
    scale = 1.0 / math.sqrt(d_in)
    return (truncated_normal(generator, (d_in, d_out)) * scale).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(vocab, d) truncated normal in [-2, 2] scaled by 0.02."""
    return (truncated_normal(generator, (vocab, d)) * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, returned in ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * gamma.to(torch.float32)
    return out.to(x.dtype)
