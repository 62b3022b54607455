"""Plain PyTorch versions of the port's kernels (the counterparts of
``repro.kernels.ref``).

The CPU tests hold them against the JAX oracles, the wrappers take them
for tensors on the CPU, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card. The main path never calls them for a CUDA
tensor.
"""

from __future__ import annotations

import math

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


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(BH, S, K) WKV6 recurrence, a Python loop over time.

    o_t = r_t · (S + diag(u)·k_tᵀv_t);  S ← diag(w_t)·S + k_tᵀv_t.
    Returns (o (BH, S, K), final state (BH, K, K)) in float32.
    """
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, w))
    uf = u.to(torch.float32)
    state = s0.to(torch.float32)
    outs = []
    for t in range(rf.shape[1]):
        k_t, v_t = kf[:, t], vf[:, t]
        kv = k_t[:, :, None] * v_t[:, None, :]                # (BH, K, K)
        outs.append(torch.sum(rf[:, t, :, None]
                              * (state + uf[:, :, None] * kv), dim=1))
        state = wf[:, t, :, None] * state + kv
    return torch.stack(outs, dim=1), state


def wkv6_recurrence_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`wkv6_ref` in the op's layout: r, k, v, w (B, S, H, K),
    u (H, K), s0 (B, H, K, K) → (o (B, S, H, K), state (B, H, K, K))."""
    B, S, H, K = r.shape

    def flat(t):
        return t.transpose(1, 2).reshape(B * H, S, K)

    o, s_fin = wkv6_ref(flat(r), flat(k), flat(v), flat(w),
                        u[None].expand(B, H, K).reshape(B * H, K),
                        s0.reshape(B * H, K, K))
    return o.reshape(B, H, S, K).transpose(1, 2), s_fin.reshape(B, H, K, K)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """(B, H, S, hd) naive attention (float32 softmax), in q's dtype.

    Keys are masked by causality (q >= k) and the window (q - k < window)
    with the finite -1e30 of the reference."""
    S, hd = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * (1.0 / math.sqrt(hd))
    pos = torch.arange(S, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)


def flash_attention_gqa_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """:func:`flash_attention_ref` in the op's layout: q (B, S, Hq, hd),
    k and v (B, S, Hk, hd) with each KV head repeated for its Hq / Hk query
    heads → (B, S, Hq, hd)."""
    G = q.shape[2] // k.shape[2]
    kt = torch.repeat_interleave(k.transpose(1, 2), G, dim=1)
    vt = torch.repeat_interleave(v.transpose(1, 2), G, dim=1)
    return flash_attention_ref(q.transpose(1, 2), kt, vt, causal=causal,
                               window=window).transpose(1, 2)
