"""MusicGen-medium's decoder (arXiv:2306.05284) as the repository models
it, in plain float32 PyTorch: the loss of a batch and its gradients.

Per layer: x += SelfAttn(RMSNorm(x)) (causal, RoPE on q and k);
x += CrossAttn(RMSNorm(x), context) (the context's own K and V, no
mask, no RoPE); x += SwiGLU(RMSNorm(x)); then a final RMSNorm, the head
and the mean token cross entropy.

Departures from the published MusicGen, all as the repository's model
has them: RMSNorm where MusicGen has LayerNorm; rotary positions where
it has sinusoidal embeddings; a SwiGLU feed-forward of width d_ff (three
matrices) where it has a GELU MLP (two); no biases; one token stream of
the codebook's 2048 ids where it interleaves four codebooks with a delay
pattern; the text encoder's projected output replaced by a context of
n_context_tokens frames drawn from the seed (``harness/traffic.py``).

Each layer is rematerialized in the backward (``torch.utils.checkpoint``)
so a full-width batch fits beside the program's state.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.harness import counts
from perfbench.harness.weights import flatten, nest
from perfbench.reference.precision import Products

F32 = torch.float32


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd), positions 0..S-1, halves rotated."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32,
                                        device=x.device) / hd))
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, causal: bool) -> torch.Tensor:
    """q (B, Sq, H, hd), k and v (B, Skv, Hk, hd) → (B, Sq, H·hd):
    softmax(q kᵀ / √hd) v, the heads of a KV group sharing k and v."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    qh = q.permute(0, 2, 1, 3)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    s = qh @ kh.transpose(-1, -2) / math.sqrt(hd)
    if causal:
        Skv = k.shape[1]
        mask = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    o = torch.softmax(s, dim=-1) @ vh
    return o.permute(0, 2, 1, 3).reshape(B, Sq, H * hd)


def _layer(arch: dict, prod: Products, names: list, x, ctx, *ws):
    p = dict(zip(names, ws))
    D, H, Hk = arch["d_model"], arch["n_heads"], arch["n_kv_heads"]
    hd = arch.get("head_dim") or D // H
    eps, theta = arch["norm_eps"], arch["rope_theta"]
    B, S, _ = x.shape
    mm = prod.mm
    h = rms_norm(x, p["ln1"], eps)
    q = rope(mm(h, p["attn/wq"]).reshape(B, S, H, hd), theta)
    k = rope(mm(h, p["attn/wk"]).reshape(B, S, Hk, hd), theta)
    v = mm(h, p["attn/wv"]).reshape(B, S, Hk, hd)
    x = x + mm(attention(q, k, v, True), p["attn/wo"])
    if ctx is not None:
        Nc = ctx.shape[1]
        h = rms_norm(x, p["ln_x"], eps)
        q = mm(h, p["xattn/wq"]).reshape(B, S, H, hd)
        k = mm(ctx, p["xattn/wk"]).reshape(B, Nc, Hk, hd)
        v = mm(ctx, p["xattn/wv"]).reshape(B, Nc, Hk, hd)
        x = x + mm(attention(q, k, v, False), p["xattn/wo"])
    h = rms_norm(x, p["ln2"], eps)
    g = mm(h, p["mlp/w_gate"])
    u = mm(h, p["mlp/w_up"])
    return x + mm(torch.nn.functional.silu(g) * u, p["mlp/w_down"])


def token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(lse - gold)


def loss_and_grads(params: dict, batch: dict, arch: dict,
                   prod: Optional[Products] = None):
    """(loss, gradients): the mean token cross entropy of ``batch``
    (tokens, labels (B, S); context (B, Nc, D) for the audio family) at
    ``params`` (the stacked tree, any dtype, read in float32), and the
    float32 gradient of every leaf, stacked as the tree is."""
    prod = prod or Products()
    L = arch["n_layers"]
    top = {k: params[k].to(F32).detach().requires_grad_()
           for k in ("embed", "final_norm", "lm_head")}
    lay = flatten(params["layers"])
    names = sorted(lay)
    per_layer = [[lay[n][i].to(F32).detach().requires_grad_()
                  for n in names] for i in range(L)]
    ctx = batch.get("context")
    ctx = None if ctx is None else ctx.to(F32)
    x = top["embed"][batch["tokens"].long()]
    for i in range(L):
        x = checkpoint(_layer, arch, prod, names, x, ctx, *per_layer[i],
                       use_reentrant=False)
    x = rms_norm(x, top["final_norm"], arch["norm_eps"])
    loss = token_ce(prod.mm(x, top["lm_head"]), batch["labels"].long())
    loss.backward()
    grads = {k: t.grad for k, t in top.items()}
    layers = {}
    for j, n in enumerate(names):
        layers[n] = torch.stack([per_layer[i][j].grad for i in range(L)])
        for i in range(L):
            per_layer[i][j].grad = None
    grads["layers"] = nest(layers)
    return loss.detach(), grads


def layout(a: dict) -> dict:
    """The weights of a dense or audio (MusicGen: cross-attention in
    every layer) transformer, {path: (shape, dtype, init rule)}:
    bfloat16 matrices, float32 norms, layers stacked on a leading
    axis."""
    if a["family"] not in ("dense", "audio"):
        raise NotImplementedError(f"no layout for family {a['family']!r}")
    L, D, V, F = a["n_layers"], a["d_model"], a["vocab_size"], a["d_ff"]
    hd = a.get("head_dim") or D // a["n_heads"]
    q, kv = a["n_heads"] * hd, a["n_kv_heads"] * hd
    out = {"embed": ((V, D), torch.bfloat16, "embed"),
           "final_norm": ((D,), torch.float32, "ones"),
           "lm_head": ((D, V), torch.bfloat16, "dense")}
    attn = {"wq": (D, q), "wk": (D, kv), "wv": (D, kv), "wo": (q, D)}
    blocks = {"attn": attn, "mlp": {"w_gate": (D, F), "w_up": (D, F),
                                    "w_down": (F, D)}}
    norms = ["ln1", "ln2"]
    if a["family"] == "audio":
        blocks["xattn"] = attn
        norms.append("ln_x")
    for n in norms:
        out[f"layers/{n}"] = ((L, D), torch.float32, "ones")
    for blk, mats in blocks.items():
        for n, shape in mats.items():
            out[f"layers/{blk}/{n}"] = ((L,) + shape, torch.bfloat16, "dense")
    return out


def forward_flops(arch: dict, n_seqs: int, S: int) -> float:
    """A dense or audio transformer's forward over n_seqs sequences of S
    tokens; the audio family attends to n_context_tokens in every
    layer."""
    L, D, V, F = arch["n_layers"], arch["d_model"], arch["vocab_size"], \
        arch["d_ff"]
    hd = arch.get("head_dim") or D // arch["n_heads"]
    Hq, Hk = arch["n_heads"], arch["n_kv_heads"]
    q, kv = Hq * hd, Hk * hd
    tokens = n_seqs * S
    per_token = 2 * (D * q + D * kv + D * kv + q * D)   # wq, wk, wv, wo
    per_token += 2 * 3 * D * F                       # SwiGLU
    attn = 4 * hd * Hq * counts.unmasked_pairs(S, True, arch.get(
        "sliding_window", 0)) * n_seqs
    flops = tokens * per_token + attn
    if arch["family"] == "audio":
        Nc = arch["n_context_tokens"]
        flops += tokens * 2 * (D * q + q * D)         # cross wq, wo
        flops += n_seqs * Nc * 2 * (D * kv + D * kv)  # cross wk, wv
        flops += 4 * hd * Hq * S * Nc * n_seqs        # cross attention
    return L * flops + tokens * 2 * D * V             # the head
