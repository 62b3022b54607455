"""Shared building blocks of the LM families (port of
``repro.models.layers``): the compute dtype, the two initializers,
RMSNorm, RoPE, the embedding lookup, attention (prefill, forward and
cross-attention through the flash kernel, or the reference's parallel-q
mode on the CPU; decode over the whole cache), the SwiGLU MLP and the
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
from repro_torch.models.mesh_ops import (contiguous_stride, first_dim_only,
                                         grad_first_dim_only, is_dtensor)

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


def _local_product(x: torch.Tensor, w: torch.Tensor,
                   weight_dims: int) -> tuple:
    """x and w for a product that each rank takes on its own rows: on a
    DTensor, w whole and x sharded on its first dim at most (the batch,
    or a bmm's experts, which w then shares). A product that sums a
    sharded dim leaves a partial sum on each rank, rounded to bfloat16
    before the parts are added; the unsharded product rounds once, and
    the RWKV-6 gradients follow that rounding closely (the reduced
    model's u by tens of percent: a float32 product rounded once moves
    it that far too). So each rank's rows are the unsharded product's,
    and only the weights' gradients add parts over the batch. A product
    also flattens x's leading dims, which DTensor (torch 2.11) refuses
    where a dim past the first is sharded: the sequence dim is gathered
    first, as Megatron-SP does before its column-parallel products. On a
    plain tensor, x and w as they are."""
    if not is_dtensor(x):
        return x, w
    from torch.distributed.tensor import Replicate, Shard
    x = first_dim_only(x)
    lead = [Shard(0) if weight_dims == 3 and p == Shard(0) else Replicate()
            for p in x.placements]
    if is_dtensor(w) and lead != list(w.placements):
        w = w.redistribute(w.device_mesh, lead)
    return x, w


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.to(x.dtype)``; on a DTensor with w whole and x sharded on
    its first dim at most (:func:`_local_product`), its gradient likewise
    (the backward flattens it)."""
    x, w = _local_product(x, w, 2)
    return grad_first_dim_only(x @ w.to(x.dtype))


def bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(x, w.to(x.dtype))`` over a leading batch (the MoE
    experts), which stays sharded; otherwise as :func:`linear`."""
    x, w = _local_product(x, w, 3)
    return torch.bmm(x, w.to(x.dtype))


class _Lookup(torch.autograd.Function):
    """The embedding lookup of a DTensor table, each rank indexing its own
    tokens in the whole table: the plain index on the local tensors, and
    its backward (``index_put_`` adding up repeated tokens) giving a
    partial sum over the mesh dims that shard the tokens, brought back to
    the table's layout. DTensor's own embedding ops leave a masked partial
    (a vocab-sharded table) that torch 2.11 mis-sizes in the backward."""

    @staticmethod
    def forward(ctx, table, tokens):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = table.device_mesh
        whole = table.redistribute(mesh, [Replicate()] * mesh.ndim)
        if is_dtensor(tokens):
            placements, idx = list(tokens.placements), tokens.to_local()
        else:
            placements, idx = [Replicate()] * mesh.ndim, tokens
        idx = idx.long()
        ctx.save_for_backward(idx)
        ctx.layout = (mesh, placements, tuple(table.shape), table.dtype,
                      tuple(table.placements))
        shape = tuple(tokens.shape) + (table.shape[1],)
        return DTensor.from_local(whole.to_local()[idx], mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        (idx,) = ctx.saved_tensors
        mesh, placements, shape, dtype, table_placements = ctx.layout
        if list(grad.placements) != placements:
            grad = grad.redistribute(mesh, placements)
        g = grad.to_local()
        local = torch.zeros(shape, dtype=dtype, device=g.device).index_put_(
            (idx,), g.to(dtype), accumulate=True)
        parts = [Partial() if isinstance(p, Shard) else Replicate()
                 for p in placements]
        out = DTensor.from_local(local, mesh, parts, run_check=False,
                                 shape=torch.Size(shape),
                                 stride=contiguous_stride(shape))
        return out.redistribute(mesh, table_placements), None


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` (V, D) at ``tokens`` (...): an index on a
    plain tensor; on a DTensor, :class:`_Lookup`, the rows sharded as the
    tokens are."""
    if is_dtensor(table):
        return _Lookup.apply(table, tokens)
    return table[tokens.long()]


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_block: int = 256, kv_block: int = 512,
                        parallel_q: bool = False) -> torch.Tensor:
    """Prefill, forward and cross-attention: q (B, Sq, Hq, hd), k and v
    (B, Skv, Hk, hd) with Hq a multiple of Hk → (B, Sq, Hq, hd); keys of
    their own length (Skv ≠ Sq) only with causal=False and window 0.
    window > 0 ⇒ sliding-window attention (pos_q − pos_k < window).

    The reference computes this in jnp with an online softmax over
    (q_block, kv_block) tiles, the query blocks one after another; here
    it is ``ops.flash_attention``, the flash kernel on the card and its
    plain version on the CPU, which picks its own tiles. ``parallel_q``
    (the reference's §Perf lever) takes every query block at once with
    only the KV blocks in turn: on the CPU that is
    :func:`parallel_q_attention`, the reference's parallel mode; on the
    card it changes nothing, since the flash kernel runs every query
    tile at once already. ``q_offset`` is not carried over (no ported
    caller sets it)."""
    if parallel_q and q.device.type == "cpu":
        return parallel_q_attention(q, k, v, causal=causal, window=window,
                                    q_block=q_block, kv_block=kv_block)
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def parallel_q_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         q_block: int = 256,
                         kv_block: int = 512) -> torch.Tensor:
    """The reference's ``blockwise_attention(parallel_q=True)``: the
    query blocks as a leading (shardable) dim (nq, B, Hk, G, qb, hd), an
    online softmax over the KV blocks in turn; scores and softmax in
    float32, the scaled q and the probabilities rounded to the inputs'
    dtype, as the reference."""
    B, Sq, Hq, hd = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    q_block, kv_block = min(q_block, Sq), min(kv_block, Skv)
    pad_q, pad_kv = (-Sq) % q_block, (-Skv) % kv_block
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
    nq, nk = (Sq + pad_q) // q_block, (Skv + pad_kv) // kv_block
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    qb = q.reshape(B, nq, q_block, Hk, G, hd).permute(1, 0, 3, 4, 2, 5)
    qb = (qb.to(torch.float32) * scale).to(q.dtype).to(torch.float32)
    kb = k.reshape(B, nk, kv_block, Hk, hd).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, nk, kv_block, Hk, hd).permute(1, 0, 3, 2, 4)
    dev = q.device
    q_pos = (torch.arange(q_block, device=dev)[None, :]
             + (torch.arange(nq, device=dev) * q_block)[:, None])
    q_pos = q_pos[:, None, None, None, :, None]           # (nq,1,1,1,qb,1)
    f32 = dict(dtype=torch.float32, device=dev)
    m = torch.full((nq, B, Hk, G, q_block), NEG_INF, **f32)
    l = torch.zeros((nq, B, Hk, G, q_block), **f32)
    acc = torch.zeros((nq, B, Hk, G, q_block, hd), **f32)
    for kj in range(nk):
        k_pos = torch.arange(kv_block, device=dev) + kj * kv_block
        sc = torch.einsum("nbhgqd,bhkd->nbhgqk", qb,
                          kb[kj].to(torch.float32))
        mask = k_pos < Skv
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window > 0:
            mask = mask & (q_pos - k_pos < window)
        sc = torch.where(mask, sc, NEG_INF)
        m_new = torch.maximum(m, torch.amax(sc, dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = corr * l + torch.sum(p, dim=-1)
        pv = torch.einsum("nbhgqk,bhkd->nbhgqd",
                          p.to(v.dtype).to(torch.float32),
                          vb[kj].to(torch.float32))
        acc = corr[..., None] * acc + pv
        m = m_new
    outs = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    out = outs.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq + pad_q, Hq, hd)
    return out[:, :Sq]


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
    g = linear(x, w_gate)
    u = linear(x, w_up)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return linear(h, w_down)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
             b_up: torch.Tensor | None = None,
             b_down: torch.Tensor | None = None) -> torch.Tensor:
    """down(gelu(x·up + b_up)) + b_down, the GELU (tanh form, as
    ``jax.nn.gelu``'s default) in float32."""
    h = linear(x, w_up)
    if b_up is not None:
        h = h + b_up.to(h.dtype)
    h = torch.nn.functional.gelu(h.to(torch.float32),
                                 approximate="tanh").to(x.dtype)
    out = linear(h, w_down)
    if b_down is not None:
        out = out + b_down.to(out.dtype)
    return out
