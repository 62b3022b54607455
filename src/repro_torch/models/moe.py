"""Mixture-of-Experts FFN with top-k routing (port of ``repro.models.moe``):
capacity dispatch with a sort-based position-in-expert (no (T, E)
one-hot cumsum), so the only large intermediate is the (E, C, D) expert
buffer.

Supports DeepSeek-MoE-style fine-grained experts with shared experts
(always on) and Phi-3.5-MoE-style classic top-2.

``capacity_factor`` 0 selects the dropless layer of one chip of an
expert-parallel deployment (:func:`_dropless`, not in the reference):
the router keeps its full width (``router_experts``), this chip holds
experts [0, n_experts) and computes every assignment to them
(``kernels.ops.moe_expert_rows``: a sort and grouped products, static
shapes, no synchronize), and an assignment to an expert held elsewhere
adds nothing here, as the deployment's exchange would bring it from
another chip.

The reference computes all of it in jnp outside any Pallas kernel, and so
does the port: the expert products are batched matrix products over E.
Both of the reference's combine modes are ported: ``gather`` (each
assignment's row picked back by its slot) and ``scatter`` (the tokens
whole, each expert's gated rows added into a (T, D) float32 output),
which the reference uses with an expert-sharded mesh
(``FwdOptions.expert_axis``) and which gives the same bits in float32
(``tests/test_layers_moe.py``). With ``expert_axis`` on a DTensor the
(E, C, D) expert buffers are pinned to that mesh axis, each rank adds
its own experts' rows into a partial output, and the output is pinned
whole, as the reference's ``with_sharding_constraint`` calls do.

Dispatch uses no float atomics: the tokens reach their slots through a
slot → token index map built by an integer scatter, where two writes
meet only in the discarded overflow row, and a gather. The routing's
integer ops run on the whole (T, k) choices on every rank of a mesh
(DTensor has no strategy for ``searchsorted``), as GSPMD replicates
them. Every op is out of place, so the FFN runs under autograd and
``torch.func.vmap``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import bmm, linear, swiglu_mlp
from repro_torch.models.mesh_ops import (constrain, grad_replicated,
                                         is_dtensor, on_mesh, replicated,
                                         whole)


class MoEConfig(NamedTuple):
    n_experts: int              # the experts held (and computed) here
    experts_per_token: int
    capacity_factor: float = 1.25   # 0: dropless
    router_jitter: float = 0.0
    router_experts: int = 0     # the router's width; 0 → n_experts
    norm_topk: bool = True      # the top-k gates renormalized to sum to 1


def router_topk(x: torch.Tensor, w_router: torch.Tensor,
                cfg: MoEConfig) -> tuple:
    """(gates (T, k) float32, expert_idx (T, k) int32, router_probs (T, R)
    float32) over the router's R outputs: a float32 router, softmax, the
    top k, the gates renormalized over the selected k where
    ``cfg.norm_topk`` (Mixtral; DeepSeek-MoE's published gating keeps the
    softmax's own)."""
    logits = linear(x.to(torch.float32), w_router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    if cfg.norm_topk:
        gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    return gates, idx.to(torch.int32), probs


def load_balance(idx: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """The Switch load-balance loss R · Σ_e f_e · p̄_e over the router's
    R experts, f_e the share of first choices."""
    R = probs.shape[-1]
    experts = torch.arange(R, device=probs.device)
    f = (idx[:, :1] == experts).to(torch.float32).mean(0)     # one-hot mean
    return R * torch.sum(f * probs.mean(0))


def position_in_expert(expert_idx: torch.Tensor,
                       n_experts: int) -> torch.Tensor:
    """Rank of each (token, k) assignment among all the assignments to its
    expert, in token-major order, by a stable sort and a search for each
    expert's first row: expert_idx (T, k) → positions (T, k) int32."""
    flat = whole(expert_idx).reshape(-1).to(torch.int64)
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


def _scatter_combine(out_buf: torch.Tensor, tok_of_slot: torch.Tensor,
                     gate_of_slot: torch.Tensor, T: int,
                     expert_axis: Optional[str]) -> torch.Tensor:
    """Each slot's gated row added into its token's row of a (T, D)
    float32 output, slots in order. With the expert buffers on a mesh
    axis, each rank adds its own experts' rows (a partial output over
    that axis) and the output is pinned whole."""
    D = out_buf.shape[-1]

    def add(rows, toks, gates):
        rows = rows.reshape(-1, D).to(torch.float32)
        return torch.zeros((T, D), dtype=torch.float32,
                           device=rows.device).index_add(
            0, toks, gates[:, None] * rows)

    if not (is_dtensor(out_buf) and expert_axis in
            out_buf.device_mesh.mesh_dim_names):
        return add(out_buf, tok_of_slot, gate_of_slot)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = out_buf.device_mesh
    ax = mesh.mesh_dim_names.index(expert_axis)
    on_e = [Shard(0) if d == ax else Replicate() for d in range(mesh.ndim)]
    partial = [Partial() if d == ax else Replicate()
               for d in range(mesh.ndim)]
    E = out_buf.shape[0]
    as_e = [_replicated_dtensor(t.reshape(E, -1), mesh)
            for t in (tok_of_slot, gate_of_slot)]
    out = local_map(lambda r, t, g: add(r, t.reshape(-1), g.reshape(-1)),
                    out_placements=partial,
                    in_placements=(on_e, on_e, on_e), device_mesh=mesh,
                    redistribute_inputs=True)(out_buf, *as_e)
    return replicated(out)


def _replicated_dtensor(t: torch.Tensor, mesh):
    """A plain tensor every rank holds whole, as a replicated DTensor."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig,
            expert_axis: Optional[str] = None,
            combine: str = "gather") -> tuple:
    """The MoE FFN over (T, D) tokens → (output (T, D) in x's dtype,
    aux loss () float32).

    params: {"router": (D, E) float32, "w_gate"/"w_up": (E, D, Fe),
    "w_down": (E, Fe, D), optional "shared": {"w_gate", "w_up",
    "w_down"}, the always-on experts}. An assignment past its expert's
    capacity C is dropped (its gate zeroed, its row sent to a trash slot
    E·C). aux is the Switch load-balance loss E · Σ_e f_e · p̄_e over the
    first choices.

    combine: "gather" (each assignment's row picked back by its slot,
    gated in x's dtype, summed over k) or "scatter" (the gated rows added
    into a float32 (T, D) output, then cast to x's dtype; with
    ``expert_axis`` the tokens are replicated first). ``expert_axis``: the
    mesh axis the (E, C, D) expert buffers are pinned to (the reference's
    ``expert_sharding`` P(axis, None, None)); the identity on plain
    tensors."""
    if combine not in ("gather", "scatter"):
        raise ValueError(f"combine must be 'gather' or 'scatter'; got "
                         f"{combine!r}")
    if cfg.capacity_factor == 0:
        return _dropless(x, params, cfg)
    if cfg.router_experts not in (0, cfg.n_experts):
        raise ValueError(f"the capacity dispatch routes over the experts it "
                         f"holds; router_experts {cfg.router_experts} != "
                         f"n_experts {cfg.n_experts} needs capacity_factor "
                         f"0 (dropless)")
    with on_mesh(x):
        return _moe_ffn(x, params, cfg, expert_axis, combine)


def _moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig,
             expert_axis: Optional[str], combine: str) -> tuple:
    T, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity(T, cfg)
    if combine == "scatter" and expert_axis is not None:
        x = replicated(x)      # dispatch is then local to each expert shard

    gates, idx, probs = router_topk(x, params["router"], cfg)
    idx = whole(idx)
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
    # the gathers index whole tensors on every rank, and take their
    # gradients whole (DTensor of torch 2.11 mis-sizes the backward of an
    # index otherwise)
    buf = (grad_replicated(replicated(x)[tok_of_slot])
           * occupied[:, None]).reshape(E, C, D)
    buf = constrain(buf, expert_axis, None, None)

    # ---- the experts, batched over E --------------------------------------
    g = bmm(buf, params["w_gate"])
    u = bmm(buf, params["w_up"])
    h = F.silu(g.to(torch.float32)).to(buf.dtype) * u
    out_buf = bmm(h, params["w_down"])                         # (E, C, D)
    out_buf = constrain(out_buf, expert_axis, None, None)

    if combine == "scatter":
        # each slot's gate; the overflow slot E·C is dropped
        gate_of_slot = torch.zeros(E * C + 1, dtype=torch.float32,
                                   device=x.device).scatter(
            0, slot, whole(gates).reshape(-1))[:E * C]
        out = _scatter_combine(out_buf, tok_of_slot, gate_of_slot, T,
                               expert_axis).to(x.dtype)
    else:
        # ---- combine: each assignment's row, gated, summed over k ---------
        rows = grad_replicated(torch.cat(
            [replicated(out_buf.reshape(E * C, D)),
             out_buf.new_zeros((1, D))])[slot])                # (T*k, D)
        picked = rows.reshape(T, k, D) * gates[..., None].to(rows.dtype)
        out = picked.sum(dim=1)

    if "shared" in params:
        sh = params["shared"]
        out = out + swiglu_mlp(x, sh["w_gate"], sh["w_up"], sh["w_down"])

    return out, load_balance(idx, probs)


def _dropless(x: torch.Tensor, params: dict, cfg: MoEConfig) -> tuple:
    """The dropless FFN of a chip that holds experts [0, n_experts) of a
    router over ``router_experts``: (out (T, D), aux ()).

    Every token's k choices are taken over the whole router; each choice
    of a held expert is computed (no capacity, nothing dropped), each
    other choice adds nothing, and the output is Σ_j gate_j · y_j over
    the choices, then the shared experts. aux is :func:`load_balance`
    over the whole router. Plain tensors only: the mesh path keeps the
    capacity dispatch."""
    if is_dtensor(x):
        raise NotImplementedError("the dropless expert layer takes plain "
                                  "tensors; a mesh runs the capacity "
                                  "dispatch (capacity_factor > 0)")
    gates, idx, probs = router_topk(x, params["router"], cfg)
    y = ops.moe_expert_rows(x, idx, params["w_gate"].to(x.dtype),
                            params["w_up"].to(x.dtype),
                            params["w_down"].to(x.dtype))      # (T, k, D)
    out = (y * gates.to(y.dtype)[..., None]).sum(dim=1)
    if "shared" in params:
        sh = params["shared"]
        out = out + swiglu_mlp(x, sh["w_gate"], sh["w_up"], sh["w_down"])
    return out, load_balance(idx, probs)
