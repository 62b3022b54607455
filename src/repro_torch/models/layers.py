"""Shared building blocks of the LM families (port of
``repro.models.layers``): the compute dtype, the two initializers,
RMSNorm, RoPE, attention (prefill, forward and cross-attention through
the flash kernel, decode over the whole cache), the SwiGLU MLP and the
GELU MLP (``gelu_mlp``, which the reference's transformer imports and
calls nowhere; ported for completeness).

Weights are plain tensors in nested dicts, as in the reference.
``jax.random`` draws cannot be reproduced in torch: the initializers
draw from a ``torch.Generator`` on the device they fill, and parity
tests load the reference's weights instead.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e30


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


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device: torch.device | str | None = None
                     ) -> torch.Tensor:
    """(head_dim / 2,) float32 inverse frequencies θ^(-2i / head_dim)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, head_dim), positions (..., S) → x rotated, computed in
    float32 and returned in x's dtype (halves rotated, not interleaved)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Prefill, forward and cross-attention: q (B, Sq, Hq, hd), k and v
    (B, Skv, Hk, hd) with Hq a multiple of Hk → (B, Sq, Hq, hd); keys of
    their own length (Skv ≠ Sq) only with causal=False and window 0.

    The reference computes this in jnp with an online softmax over
    (q_block, kv_block) tiles; here it is ``ops.flash_attention``, the
    flash kernel on the card and its plain version on the CPU, which
    picks its own tiles. The reference's other options are not carried
    over: ``q_offset`` (no ported caller sets it) and ``parallel_q`` (a
    mesh lever, ROADMAP Queue 1 item 15, the execution half). window > 0
    ⇒ sliding-window attention (pos_q − pos_k < window)."""
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token decode attention over a (B, S, Hk, hd) KV cache,
    masked over the whole cache to the slots at or before ``pos`` (and
    within the window): q (B, 1, Hq, hd) → (B, 1, Hq, hd).

    As the reference: the scaled q and the probabilities are rounded to
    the cache's dtype and both products sum in float32."""
    B, S, Hk, hd = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hk
    scale = 1.0 / math.sqrt(hd)
    qg = (q.reshape(B, Hk, G, hd).to(torch.float32) * scale).to(q.dtype)
    s = torch.einsum("bhgd,bshd->bhgs", qg.to(torch.float32),
                     k_cache.to(torch.float32))                 # (B,Hk,G,S)
    idx = torch.arange(S, device=q.device)
    mask = idx <= pos
    if window > 0:
        mask = mask & (pos - idx < window)
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd",
                       p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(B, 1, Hq, hd).to(q.dtype)


def swiglu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """down(silu(x·gate) ⊙ x·up), the SiLU in float32."""
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return h @ w_down.to(x.dtype)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
             b_up: torch.Tensor | None = None,
             b_down: torch.Tensor | None = None) -> torch.Tensor:
    """down(gelu(x·up + b_up)) + b_down, the GELU (tanh form, as
    ``jax.nn.gelu``'s default) in float32."""
    h = x @ w_up.to(x.dtype)
    if b_up is not None:
        h = h + b_up.to(h.dtype)
    h = torch.nn.functional.gelu(h.to(torch.float32),
                                 approximate="tanh").to(x.dtype)
    out = h @ w_down.to(x.dtype)
    if b_down is not None:
        out = out + b_down.to(out.dtype)
    return out
