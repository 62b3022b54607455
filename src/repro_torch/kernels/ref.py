"""Plain PyTorch versions of the port's kernels (the counterparts of
``repro.kernels.ref``), forward and backward.

The CPU tests hold them against the JAX oracles, the wrappers take them
for tensors on the CPU, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card. The main path never calls them for a CUDA
tensor. The backward versions are written out, not taken by autograd:
the reference has no Pallas backward (it differentiates ``lax.scan`` and
the jnp blockwise attention), so these equations are what the backward
kernels compute.
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


def wkv6_backward_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                      d_o: torch.Tensor, d_state: torch.Tensor | None = None):
    """The gradient of :func:`wkv6_recurrence_ref` in the op's layout:
    r, k, v, w, d_o (B, S, H, K), u (H, K), s0 and d_state (the gradient
    of the final state, zeros if None) (B, H, K, K) → (dr, dk, dv, dw
    (B, S, H, K), du (H, K), ds0 (B, H, K, K)), all float32.

    The states before every step, S_{t-1}, come from running the
    recurrence forward from s0 and keeping them; they never come from
    dividing by w, which can be ~0. Then, walking t downward with dS the
    gradient of the state after step t:

        dr_t[i] = Σ_j dO_t[j]·(S_{t-1}[i,j] + u[i]·k_t[i]·v_t[j])
        dk_t[i] = Σ_j (dS[i,j] + u[i]·r_t[i]·dO_t[j])·v_t[j]
        dv_t[j] = Σ_i k_t[i]·(dS[i,j] + u[i]·r_t[i]·dO_t[j])
        dw_t[i] = Σ_j dS[i,j]·S_{t-1}[i,j]
        du[i]  += r_t[i]·k_t[i]·Σ_j dO_t[j]·v_t[j]
        dS     ← diag(w_t)·dS + r_tᵀ·dO_t;   ds0 = the last dS.
    """
    B, S, H, K = r.shape

    def flat(t):
        return t.to(torch.float32).transpose(1, 2).reshape(B * H, S, K)

    rf, kf, vf, wf, dof = (flat(t) for t in (r, k, v, w, d_o))
    uf = u.to(torch.float32)[None].expand(B, H, K).reshape(B * H, K)
    state = s0.to(torch.float32).reshape(B * H, K, K)
    before = []
    for t in range(S):
        before.append(state)
        state = (wf[:, t, :, None] * state
                 + kf[:, t, :, None] * vf[:, t, None, :])
    ds = (torch.zeros_like(state) if d_state is None
          else d_state.to(torch.float32).reshape(B * H, K, K).clone())
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for t in reversed(range(S)):
        r_t, k_t, v_t, w_t, do_t = (x[:, t] for x in (rf, kf, vf, wf, dof))
        prev = before[t]
        dot = torch.sum(do_t * v_t, dim=-1, keepdim=True)     # (BH, 1)
        e = ds + (uf * r_t)[:, :, None] * do_t[:, None, :]
        dr[:, t] = torch.einsum("nij,nj->ni", prev, do_t) + uf * k_t * dot
        dk[:, t] = torch.einsum("nij,nj->ni", e, v_t)
        dv[:, t] = torch.einsum("ni,nij->nj", k_t, e)
        dw[:, t] = torch.sum(ds * prev, dim=-1)
        du = du + r_t * k_t * dot
        ds = w_t[:, :, None] * ds + r_t[:, :, None] * do_t[:, None, :]

    def unflat(t):
        return t.reshape(B, H, S, K).transpose(1, 2).contiguous()

    return (unflat(dr), unflat(dk), unflat(dv), unflat(dw),
            du.reshape(B, H, K).sum(0), ds.reshape(B, H, K, K))


def _attention_mask(Sq: int, Skv: int, causal: bool, window: int,
                    device) -> torch.Tensor:
    """(Sq, Skv) keys each query keeps: causality (q >= k) and the window
    (q - k < window), query and key positions both counted from 0."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    """(B, H, Sq, Skv) float32 scaled scores, the reference's finite -1e30
    where masked."""
    hd = q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * (1.0 / math.sqrt(hd))
    return s.masked_fill(~_attention_mask(q.shape[2], k.shape[2], causal,
                                          window, q.device), -1e30)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q (B, H, Sq, hd), k and v (B, H, Skv, hd) → (B, H, Sq, hd): naive
    attention (float32 softmax), in q's dtype.

    Keys are masked by causality (q >= k) and the window (q - k < window)
    with the finite -1e30 of the reference."""
    p = torch.softmax(_scores(q, k, causal, window), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)


def flash_attention_gqa_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """:func:`flash_attention_ref` in the op's layout: q (B, Sq, Hq, hd),
    k and v (B, Skv, Hk, hd) with each KV head repeated for its Hq / Hk
    query heads → (B, Sq, Hq, hd)."""
    G = q.shape[2] // k.shape[2]
    kt = torch.repeat_interleave(k.transpose(1, 2), G, dim=1)
    vt = torch.repeat_interleave(v.transpose(1, 2), G, dim=1)
    return flash_attention_ref(q.transpose(1, 2), kt, vt, causal=causal,
                               window=window).transpose(1, 2)


def _kv_by_index(t: torch.Tensor, G: int) -> torch.Tensor:
    """(B, Skv, Hk, hd) → (B, Hk·G, Skv, hd) float32: query head h reads
    kv head h // G."""
    return torch.repeat_interleave(t.to(torch.float32).transpose(1, 2), G,
                                   dim=1)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """The per-row logsumexp L = m + log l of the scaled, masked scores
    (natural log), float32 (B, Hq, S): what the forward kernel writes for
    its backward. q (B, Sq, Hq, hd), k (B, Skv, Hk, hd)."""
    G = q.shape[2] // k.shape[2]
    return torch.logsumexp(_scores(q.transpose(1, 2), _kv_by_index(k, G),
                                   causal, window), dim=-1)


def flash_attention_backward_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, o: torch.Tensor,
                                 lse: torch.Tensor, d_o: torch.Tensor, *,
                                 causal: bool = True, window: int = 0):
    """The gradient of :func:`flash_attention_gqa_ref`: q, o, d_o
    (B, Sq, Hq, hd), k, v (B, Skv, Hk, hd), lse (B, Hq, Sq) from the forward
    → (dq, dk, dv) in q's dtype, computed in float32. With P recomputed
    from L (masked scores are the finite -1e30, so P is 0 there):

        P = exp(s - L),  D_i = Σ_d dO[i,d]·O[i,d],  dV = Pᵀ·dO,
        dS = P ∘ (dO·Vᵀ - D),  dQ = scale·dS·K,  dK = scale·dSᵀ·Q,

    query head h reading kv head h // G, and dK, dV of a kv head summed
    over its G query heads in index order."""
    B, _, Hq, hd = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    scale = 1.0 / math.sqrt(hd)
    qf = q.to(torch.float32).transpose(1, 2)
    kf, vf = _kv_by_index(k, G), _kv_by_index(v, G)
    dof = d_o.to(torch.float32).transpose(1, 2)
    p = torch.exp(_scores(qf, kf, causal, window)
                  - lse.to(torch.float32)[..., None])
    D = torch.sum(dof * o.to(torch.float32).transpose(1, 2), dim=-1)
    ds = p * (dof @ vf.transpose(2, 3) - D[..., None])
    dq = (ds @ kf) * scale
    dk_h = (ds.transpose(2, 3) @ qf) * scale           # (B, Hq, Skv, hd)
    dv_h = p.transpose(2, 3) @ dof

    def per_kv_head(t):
        t = t.reshape(B, Hk, G, Skv, hd)
        acc = t[:, :, 0]
        for g in range(1, G):
            acc = acc + t[:, :, g]
        return acc.transpose(1, 2).to(q.dtype)

    return (dq.transpose(1, 2).to(q.dtype), per_kv_head(dk_h),
            per_kv_head(dv_h))
