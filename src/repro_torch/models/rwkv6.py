"""RWKV-6 "Finch" block (arXiv:2404.05892) — attention-free time mixing
with data-dependent decay, plus squared-ReLU channel mixing.

Port of ``repro.models.rwkv6``, with the same parameter names, shapes,
dtypes and casts:

  lerp_□(x_t) = x_t + (x_{t-1} − x_t) ⊙ μ_□            (token shift)
  w_t = exp(−exp(w0 + tanh(lerp_w x · A_w) B_w))        (data-dependent decay)
  r_t, k_t, v_t, g_t = W_□ · lerp_□(x)
  S_t = diag(w_t) S_{t−1} + k_tᵀ v_t                    (per head, K×V state)
  o_t = r_t · (S_{t−1} + diag(u) k_tᵀ v_t)
  out = W_o · (GroupNorm(o) ⊙ SiLU(g))

The recurrence goes through :func:`repro_torch.kernels.ops.wkv6_recurrence`:
the hand-written CUDA kernel for a CUDA tensor, the plain loop over time
for a CPU tensor. There is no switch between them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import wkv6_recurrence
from repro_torch.models.layers import dense_init, rms_norm


class RWKVConfig(NamedTuple):
    d_model: int
    head_size: int = 64
    d_ff: int = 0            # channel-mix hidden; 3.5x d_model if 0
    decay_lora: int = 64

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_size

    @property
    def ffn_dim(self) -> int:
        return self.d_ff or int(3.5 * self.d_model)


def rwkv_block_init(cfg: RWKVConfig, generator: torch.Generator) -> dict:
    """One block's parameters, drawn on ``generator.device``."""
    D, H, K = cfg.d_model, cfg.n_heads, cfg.head_size
    f32 = dict(dtype=torch.float32, device=generator.device)

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out)

    return {
        "norm1": torch.ones((D,), **f32),
        "norm2": torch.ones((D,), **f32),
        "mu": 0.5 * torch.ones((5, D), **f32),      # r,k,v,g,w token-shift mixes
        "w0": -6.0 * torch.ones((D,), **f32),
        "w_lora_a": dense(D, cfg.decay_lora) * 0.1,
        "w_lora_b": dense(cfg.decay_lora, D) * 0.1,
        "u": torch.zeros((H, K), **f32),            # current-token bonus
        "wr": dense(D, D),
        "wk": dense(D, D),
        "wv": dense(D, D),
        "wg": dense(D, D),
        "wo": dense(D, D),
        "ln_x": torch.ones((D,), **f32),            # per-head group norm scale
        # channel mixing
        "mu_ffn": 0.5 * torch.ones((2, D), **f32),
        "wk_ffn": dense(D, cfg.ffn_dim),
        "wv_ffn": dense(cfg.ffn_dim, D),
        "wr_ffn": dense(D, D),
    }


def _group_norm(x: torch.Tensor, scale: torch.Tensor, n_heads: int,
                eps: float = 64e-5) -> torch.Tensor:
    """Per-head layer norm over the head channel (RWKV's ln_x)."""
    B, S, D = x.shape
    xh = x.reshape(B, S, n_heads, D // n_heads).to(torch.float32)
    mean = torch.mean(xh, dim=-1, keepdim=True)
    var = torch.var(xh, dim=-1, keepdim=True, correction=0)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    return (xh.reshape(B, S, D) * scale.to(torch.float32)).to(x.dtype)


def _token_shift(x: torch.Tensor,
                 x_prev_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, D) → previous-token tensor; x_prev_last seeds position 0."""
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if x_prev_last is not None:
        shifted = shifted.clone()
        shifted[:, 0] = x_prev_last.to(x.dtype)
    return shifted


def _time_mix_inputs(params: dict, x: torch.Tensor, shifted: torch.Tensor,
                     cfg: RWKVConfig):
    mu = params["mu"].to(x.dtype)                          # (5, D)
    lerp = x[None] + (shifted - x)[None] * mu[:, None, None, :]   # (5,B,S,D)
    xr, xk, xv, xg, xw = lerp
    r = xr @ params["wr"].to(x.dtype)
    k = xk @ params["wk"].to(x.dtype)
    v = xv @ params["wv"].to(x.dtype)
    g = xg @ params["wg"].to(x.dtype)
    # data-dependent decay (the Finch contribution)
    dd = torch.tanh(xw.to(torch.float32) @ params["w_lora_a"])
    dd = dd @ params["w_lora_b"]
    w = torch.exp(-torch.exp(params["w0"].to(torch.float32) + dd))  # (0, 1)
    return r, k, v, g, w


def rwkv_time_mix(params: dict, x: torch.Tensor, cfg: RWKVConfig,
                  state: Optional[torch.Tensor] = None,
                  shift_state: Optional[torch.Tensor] = None,
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the WKV6 recurrence over (B, S, D).

    state: (B, H, K, V) carry; shift_state: (B, D) last token of prev chunk.
    Returns (out, new_state, new_shift_state).
    """
    B, S, D = x.shape
    H, K = cfg.n_heads, cfg.head_size
    shifted = _token_shift(x, shift_state)
    r, k, v, g, w = _time_mix_inputs(params, x, shifted, cfg)

    rh = r.reshape(B, S, H, K).to(torch.float32)
    kh = k.reshape(B, S, H, K).to(torch.float32)
    vh = v.reshape(B, S, H, K).to(torch.float32)
    wh = w.reshape(B, S, H, K)
    u = params["u"].to(torch.float32)                      # (H, K)

    if state is None:
        state = torch.zeros((B, H, K, K), dtype=torch.float32,
                            device=x.device)

    outs, new_state = wkv6_recurrence(rh, kh, vh, wh, u, state)
    o = outs.reshape(B, S, D).to(x.dtype)
    o = _group_norm(o, params["ln_x"], H)
    o = o * F.silu(g.to(torch.float32)).to(o.dtype)
    out = o @ params["wo"].to(o.dtype)
    return out, new_state, x[:, -1]


def rwkv_channel_mix(params: dict, x: torch.Tensor, cfg: RWKVConfig,
                     shift_state: Optional[torch.Tensor] = None,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    shifted = _token_shift(x, shift_state)
    mu = params["mu_ffn"].to(x.dtype)
    xk = x + (shifted - x) * mu[0]
    xr = x + (shifted - x) * mu[1]
    kk = xk @ params["wk_ffn"].to(x.dtype)
    kk = torch.square(torch.relu(kk.to(torch.float32))).to(x.dtype)
    vv = kk @ params["wv_ffn"].to(x.dtype)
    rr = torch.sigmoid(
        (xr @ params["wr_ffn"].to(x.dtype)).to(torch.float32)).to(x.dtype)
    return rr * vv, x[:, -1]


class RWKVBlockState(NamedTuple):
    wkv: torch.Tensor          # (B, H, K, K)
    shift_tm: torch.Tensor     # (B, D)
    shift_cm: torch.Tensor     # (B, D)


def rwkv_block_apply(params: dict, x: torch.Tensor, cfg: RWKVConfig,
                     state: Optional[RWKVBlockState] = None,
                     ) -> tuple[torch.Tensor, RWKVBlockState]:
    h = rms_norm(x, params["norm1"])
    tm, wkv, sh_tm = rwkv_time_mix(
        params, h, cfg,
        state=None if state is None else state.wkv,
        shift_state=None if state is None else state.shift_tm)
    x = x + tm
    h = rms_norm(x, params["norm2"])
    cm, sh_cm = rwkv_channel_mix(
        params, h, cfg,
        shift_state=None if state is None else state.shift_cm)
    x = x + cm
    return x, RWKVBlockState(wkv, sh_tm, sh_cm)


def rwkv_init_state(cfg: RWKVConfig, batch: int,
                    device: torch.device | str) -> RWKVBlockState:
    f32 = dict(dtype=torch.float32, device=device)
    return RWKVBlockState(
        torch.zeros((batch, cfg.n_heads, cfg.head_size, cfg.head_size), **f32),
        torch.zeros((batch, cfg.d_model), **f32),
        torch.zeros((batch, cfg.d_model), **f32))
