"""Mixture-of-Experts FFN with top-k routing (port of ``repro.models.moe``):
capacity dispatch with a sort-based position-in-expert (no (T, E)
one-hot cumsum), so the only large intermediate is the (E, C, D) expert
buffer.

Supports DeepSeek-MoE-style fine-grained experts with shared experts
(always on) and Phi-3.5-MoE-style classic top-2.

The reference computes all of it in jnp outside any Pallas kernel, and so
does the port: the expert products are batched matrix products over E.
Of the reference's two combine modes only ``gather`` is ported; its
``scatter`` mode gives the same bits (``tests/test_layers_moe.py``) and
exists for an expert-sharded mesh (ROADMAP Queue 1 item 15).

Dispatch uses no float atomics: the tokens reach their slots through a
slot → token index map built by an integer scatter, where two writes
meet only in the discarded overflow row, and a gather. Every op is out
of place, so the FFN runs under autograd and ``torch.func.vmap``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import swiglu_mlp


class MoEConfig(NamedTuple):
    n_experts: int
    experts_per_token: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


def router_topk(x: torch.Tensor, w_router: torch.Tensor,
                cfg: MoEConfig) -> tuple:
    """(gates (T, k) float32, expert_idx (T, k) int32, router_probs (T, E)
    float32): a float32 router, softmax, the top k, the gates
    renormalized over the selected k (DeepSeek-MoE / Mixtral)."""
    logits = x.to(torch.float32) @ w_router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, idx.to(torch.int32), probs


def position_in_expert(expert_idx: torch.Tensor,
                       n_experts: int) -> torch.Tensor:
    """Rank of each (token, k) assignment among all the assignments to its
    expert, in token-major order, by a stable sort and a search for each
    expert's first row: expert_idx (T, k) → positions (T, k) int32."""
    flat = expert_idx.reshape(-1).to(torch.int64)
    n = flat.shape[0]
    order = torch.argsort(flat, stable=True)            # grouped by expert
    sorted_e = flat[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, dtype=torch.int64,
                               device=flat.device))
    rank_sorted = torch.arange(n, device=flat.device) - starts[sorted_e]
    pos = torch.zeros_like(flat).scatter(0, order, rank_sorted)
    return pos.reshape(expert_idx.shape).to(torch.int32)


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert: ceil(T·k / E · capacity_factor), at least k."""
    k = cfg.experts_per_token
    return max(int(math.ceil(n_tokens * k / cfg.n_experts
                             * cfg.capacity_factor)), k)


def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig) -> tuple:
    """The MoE FFN over (T, D) tokens → (output (T, D) in x's dtype,
    aux loss () float32), the reference's ``gather`` combine.

    params: {"router": (D, E) float32, "w_gate"/"w_up": (E, D, Fe),
    "w_down": (E, Fe, D), optional "shared": {"w_gate", "w_up",
    "w_down"}, the always-on experts}. An assignment past its expert's
    capacity C is dropped (its gate zeroed, its row sent to a trash slot
    E·C). aux is the Switch load-balance loss E · Σ_e f_e · p̄_e over the
    first choices."""
    T, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity(T, cfg)

    gates, idx, probs = router_topk(x, params["router"], cfg)
    pos = position_in_expert(idx, E)                           # (T, k)
    kept = pos < C
    gates = gates * kept.to(gates.dtype)                       # drop overflow

    # ---- dispatch: slot → token map, then a gather ------------------------
    slot = torch.where(kept, idx.to(torch.int64) * C
                       + torch.clamp(pos, max=C - 1).to(torch.int64),
                       E * C).reshape(-1)                      # (T*k,)
    # the token of each (token, choice) row; arange // k, where
    # repeat_interleave would wait for the device to size its output
    tok_ids = torch.arange(T * k, device=x.device) // k
    tok_of_slot = torch.zeros(E * C + 1, dtype=torch.int64,
                              device=x.device).scatter(0, slot,
                                                       tok_ids)[:E * C]
    occupied = torch.zeros(E * C + 1, dtype=x.dtype, device=x.device
                           ).scatter(0, slot,
                                     kept.reshape(-1).to(x.dtype))[:E * C]
    buf = (x[tok_of_slot] * occupied[:, None]).reshape(E, C, D)

    # ---- the experts, batched over E --------------------------------------
    g = torch.bmm(buf, params["w_gate"].to(buf.dtype))
    u = torch.bmm(buf, params["w_up"].to(buf.dtype))
    h = F.silu(g.to(torch.float32)).to(buf.dtype) * u
    out_buf = torch.bmm(h, params["w_down"].to(buf.dtype))     # (E, C, D)

    # ---- combine: each assignment's row, gated, summed over k --------------
    rows = torch.cat([out_buf.reshape(E * C, D),
                      out_buf.new_zeros((1, D))])[slot]        # (T*k, D)
    picked = rows.reshape(T, k, D) * gates[..., None].to(rows.dtype)
    out = picked.sum(dim=1)

    if "shared" in params:
        sh = params["shared"]
        out = out + swiglu_mlp(x, sh["w_gate"], sh["w_up"], sh["w_down"])

    experts = torch.arange(E, device=x.device)
    f = (idx[:, :1] == experts).to(torch.float32).mean(0)     # one-hot mean
    p_bar = probs.mean(0)
    aux = E * torch.sum(f * p_bar)
    return out, aux
