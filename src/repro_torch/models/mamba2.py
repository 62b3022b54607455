"""Mamba-2 (SSD) block for the Zamba2 hybrid (arXiv:2411.15242 backbone,
SSD recurrence from Dao & Gu 2024).

Port of ``repro.models.mamba2``, with the same parameter names, shapes,
dtypes and casts:

  u = in_proj(x) → [z (gate), xc, B, C, dt]
  xc, B, C pass through a short causal depthwise conv (kernel 4)
  a_t = exp(−softplus(dt_t + dt_bias) · exp(A_log))      per-head scalar decay
  S_t = a_t S_{t−1} + (dt_t x_t) ⊗ B_t                    state (P × N) per head
  y_t = S_t C_t + D ⊙ x_t
  out = out_proj(y ⊙ SiLU(z))

The reference runs the recurrence as ``lax.scan`` over time, outside any
Pallas kernel; here it is a plain loop over time with a float32 state
(B, H, P, N). Kept from the reference: the weights are float32 (its
``dense_init`` gets no dtype), the block's RMSNorm uses the default eps
1e-6, the conv runs in x's dtype unrolled over its K taps, and the conv
state leaves a step in x's dtype though it starts in float32. The
reference's ``sharded`` pin is a mesh lever (ROADMAP Queue 1 item 15)
and is not carried over.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm


class Mamba2Config(NamedTuple):
    d_model: int
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba2_param_shapes(cfg: Mamba2Config) -> dict:
    """{name: shape} of one block's parameters, all float32."""
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    return {"norm": (D,), "in_proj": (D, 2 * DI + 2 * N + H),
            "conv_w": (cfg.conv_kernel, DI + 2 * N), "conv_b": (DI + 2 * N,),
            "dt_bias": (H,), "A_log": (H,), "D": (H,), "out_proj": (DI, D)}


def mamba2_init(cfg: Mamba2Config, generator: torch.Generator) -> dict:
    """One block's float32 parameters, drawn on ``generator.device``;
    ``in_proj`` packs [z, xc, B, C, dt]."""
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    f32 = dict(dtype=torch.float32, device=generator.device)
    shapes = mamba2_param_shapes(cfg)
    return {
        "norm": torch.ones((D,), **f32),
        "in_proj": dense_init(generator, D, shapes["in_proj"][1]),
        "conv_w": torch.randn(shapes["conv_w"], generator=generator,
                              **f32) * 0.1,
        "conv_b": torch.zeros((DI + 2 * N,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "out_proj": dense_init(generator, DI, D),
    }


class Mamba2State(NamedTuple):
    ssm: torch.Tensor    # (B, H, P, N) float32
    conv: torch.Tensor   # (B, K-1, DI + 2N): trailing conv inputs


def mamba2_init_state(cfg: Mamba2Config, batch: int,
                      device: torch.device | str) -> Mamba2State:
    f32 = dict(dtype=torch.float32, device=device)
    return Mamba2State(
        torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state), **f32),
        torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_inner + 2 * cfg.d_state),
                    **f32))


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prefix: Optional[torch.Tensor] = None) -> tuple:
    """Depthwise causal conv over (B, S, C) in u's dtype; returns (out,
    the new trailing state: the last K-1 inputs, in u's dtype)."""
    K = w.shape[0]
    S = u.shape[1]
    if prefix is None:
        prefix = u.new_zeros((u.shape[0], K - 1, u.shape[2]))
    up = torch.cat([prefix.to(u.dtype), u], dim=1)        # (B, S+K-1, C)
    out = torch.zeros_like(u)
    for i in range(K):      # a short static unroll (K = 4)
        out = out + up[:, i:i + S] * w[i].to(u.dtype)
    out = F.silu((out + b.to(u.dtype)).to(torch.float32)).to(u.dtype)
    return out, up[:, -(K - 1):]


def mamba2_apply(params: dict, x: torch.Tensor, cfg: Mamba2Config,
                 state: Optional[Mamba2State] = None) -> tuple:
    """x (B, S, D) → (out (B, S, D) in x's dtype, new state). The residual
    is the caller's job. Written out of place, so it runs under autograd
    and ``torch.func.vmap``."""
    B, S, _ = x.shape
    DI, N, H, P = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim

    h = rms_norm(x, params["norm"])
    u = h @ params["in_proj"].to(h.dtype)
    z, conv_in, dt_raw = torch.split(u, [DI, DI + 2 * N, H], dim=-1)

    conv_out, new_conv = _causal_conv(
        conv_in, params["conv_w"], params["conv_b"],
        None if state is None else state.conv)
    xc, b_mat, c_mat = torch.split(conv_out, [DI, N, N], dim=-1)

    dt = F.softplus(dt_raw.to(torch.float32)
                    + params["dt_bias"].to(torch.float32))     # (B, S, H)
    a = torch.exp(-dt * torch.exp(params["A_log"].to(torch.float32)))

    xh = xc.reshape(B, S, H, P).to(torch.float32)
    dtx = xh * dt[..., None]                                   # (B, S, H, P)
    ssm = (x.new_zeros((B, H, P, N), dtype=torch.float32) if state is None
           else state.ssm)
    bf = b_mat.to(torch.float32)                               # (B, S, N)
    cf = c_mat.to(torch.float32)
    ys = []
    for t in range(S):
        ssm = (a[:, t, :, None, None] * ssm
               + dtx[:, t, :, :, None] * bf[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", ssm, cf[:, t]))
    y = torch.stack(ys, dim=1)                                 # (B, S, H, P)
    # out of the float32 state straight away, as the reference
    y = (y + params["D"].to(torch.float32)[None, None, :, None] * xh
         ).to(x.dtype)
    y = y.reshape(B, S, DI)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    out = y @ params["out_proj"].to(y.dtype)
    return out, Mamba2State(ssm, new_conv)
