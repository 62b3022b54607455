"""DeepSeekMoE 16B's decoder (arXiv:2401.06066; the model's published
config.json) as one chip of an expert-parallel deployment computes it,
in plain float32 PyTorch: the loss of a batch and its gradients.

Per layer: x += SelfAttn(RMSNorm(x)) (causal, RoPE on q and k, 16 heads
of 128); then x += FFN(RMSNorm(x)). The first ``first_dense_layers``
layers have a dense SwiGLU of width d_ff. Every other layer has the
expert FFN: a router over ``router_experts`` experts, softmax scores,
the top ``experts_per_token`` taken greedily, the gates as the softmax
gives them (``norm_topk`` false: not renormalized), each choice's
expert a SwiGLU of width ``moe_d_ff``; the shared experts, one SwiGLU
of width n_shared_experts · moe_d_ff, for every token. Then a final
RMSNorm, the head, and the loss: the mean token cross entropy plus 0.01
times the load-balance term summed over the expert layers.

The cut, as in the program: this chip holds experts [0, n_experts) of
the router's ``router_experts``; a choice of an expert held here is
computed (every one: no capacity, nothing dropped), a choice of any
other expert adds nothing (the deployment's exchange would bring it from
its chip). The experts are walked one at a time, each over the tokens
that chose it; there is no sort.

Departures from the published model: the load-balance term is the
program's, R · Σ_e f_e · p̄_e over the router's R experts with f_e the
share of first choices, at weight 0.01, where DeepSeekMoE has an
expert-level balance loss over all k choices (α1 0.001) and a
device-level one; the vocabulary is the chip's eighth of it (the
configuration's ``vocab_size``), the depth one pipeline stage.

Each layer is rematerialized in the backward (``torch.utils.checkpoint``)
so a full-width batch fits beside the program's state.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.harness import counts
from perfbench.harness.weights import flatten, nest
from perfbench.reference.precision import Products
from perfbench.reference.transformer import attention, rms_norm, rope, \
    token_ce

F32 = torch.float32
STACKS = ("dense_layers", "layers")     # in the order they run
AUX_WEIGHT = 0.01


def _swiglu(prod: Products, x, w_gate, w_up, w_down):
    mm = prod.mm
    return mm(torch.nn.functional.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def _experts(arch: dict, prod: Products, p: dict, h: torch.Tensor) -> tuple:
    """The expert FFN of the (T, D) tokens ``h``: (out (T, D), the
    load-balance term ())."""
    E, k = arch["n_experts"], arch["experts_per_token"]
    probs = torch.softmax(prod.mm(h, p["moe/router"]), dim=-1)    # (T, R)
    R = probs.shape[-1]
    gates, idx = torch.topk(probs, k, dim=-1)
    if arch.get("norm_topk", True):
        gates = gates / gates.sum(dim=-1, keepdim=True)
    out = _swiglu(prod, h, p["moe/shared/w_gate"], p["moe/shared/w_up"],
                  p["moe/shared/w_down"]) if "moe/shared/w_gate" in p \
        else torch.zeros_like(h)
    for e in range(E):
        tok, j = torch.nonzero(idx == e, as_tuple=True)
        if not len(tok):
            continue
        y = _swiglu(prod, h[tok], p["moe/w_gate"][e], p["moe/w_up"][e],
                    p["moe/w_down"][e])
        out = out.index_add(0, tok, gates[tok, j][:, None] * y)
    first = torch.nn.functional.one_hot(idx[:, 0], R).to(F32).mean(0)
    return out, R * torch.sum(first * probs.mean(0))


def _layer(arch: dict, prod: Products, names: list, x, *ws):
    """One layer: (x, its load-balance term (), 0 for a dense layer)."""
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
    h = rms_norm(x, p["ln2"], eps)
    if "mlp/w_gate" in p:
        return x + _swiglu(prod, h, p["mlp/w_gate"], p["mlp/w_up"],
                           p["mlp/w_down"]), torch.zeros((), device=x.device)
    out, aux = _experts(arch, prod, p, h.reshape(B * S, D))
    return x + out.reshape(B, S, D), aux


def loss_and_grads(params: dict, batch: dict, arch: dict,
                   prod: Optional[Products] = None):
    """(loss, gradients): the loss of ``batch`` (tokens, labels (B, S))
    at ``params`` (the stacked tree, any dtype, read in float32), and the
    float32 gradient of every leaf, stacked as the tree is."""
    prod = prod or Products()
    top = {k: params[k].to(F32).detach().requires_grad_()
           for k in ("embed", "final_norm", "lm_head")}
    stacks = []
    for stack in STACKS:
        if stack not in params:
            continue
        lay = flatten(params[stack])
        names = sorted(lay)
        L = lay[names[0]].shape[0]
        stacks.append((stack, names, [[lay[n][i].to(F32).detach()
                                       .requires_grad_() for n in names]
                                      for i in range(L)]))
    x = top["embed"][batch["tokens"].long()]
    aux = torch.zeros((), device=x.device)
    for _, names, per_layer in stacks:
        for ws in per_layer:
            x, a = checkpoint(_layer, arch, prod, names, x, *ws,
                              use_reentrant=False)
            aux = aux + a
    x = rms_norm(x, top["final_norm"], arch["norm_eps"])
    loss = token_ce(prod.mm(x, top["lm_head"]), batch["labels"].long()) \
        + AUX_WEIGHT * aux
    loss.backward()
    grads = {k: t.grad for k, t in top.items()}
    for stack, names, per_layer in stacks:
        out = {}
        for j, n in enumerate(names):
            # a layer none of whose tokens chose a held expert leaves its
            # expert stacks out of the graph: their gradient is zero
            out[n] = torch.stack([torch.zeros_like(ws[j]) if ws[j].grad is
                                  None else ws[j].grad for ws in per_layer])
            for ws in per_layer:
                ws[j].grad = None
        grads[stack] = nest(out)
    return loss.detach(), grads


def layout(a: dict) -> dict:
    """The weights, {path: (shape, dtype, init rule)}: bfloat16 matrices,
    a float32 router, float32 norms; the leading dense layers stacked in
    ``dense_layers``, the expert layers in ``layers``, each expert stack
    (L, E, ·, ·) over the E experts held."""
    if a["family"] != "moe":
        raise NotImplementedError(f"no layout for family {a['family']!r}")
    L, D, V, F = a["n_layers"], a["d_model"], a["vocab_size"], a["d_ff"]
    Ld = a.get("first_dense_layers", 0)
    E, Fe = a["n_experts"], a["moe_d_ff"]
    R = a.get("router_experts") or E
    Fs = Fe * a.get("n_shared_experts", 0)
    hd = a.get("head_dim") or D // a["n_heads"]
    q, kv = a["n_heads"] * hd, a["n_kv_heads"] * hd
    bf16 = torch.bfloat16
    out = {"embed": ((V, D), bf16, "embed"),
           "final_norm": ((D,), F32, "ones"),
           "lm_head": ((D, V), bf16, "dense")}
    attn = {"attn/wq": (D, q), "attn/wk": (D, kv), "attn/wv": (D, kv),
            "attn/wo": (q, D)}
    dense = dict(attn, **{"mlp/w_gate": (D, F), "mlp/w_up": (D, F),
                          "mlp/w_down": (F, D)})
    moe = dict(attn, **{"moe/w_gate": (E, D, Fe), "moe/w_up": (E, D, Fe),
                        "moe/w_down": (E, Fe, D)})
    if Fs:
        moe.update({"moe/shared/w_gate": (D, Fs), "moe/shared/w_up": (D, Fs),
                    "moe/shared/w_down": (Fs, D)})
    for stack, n, mats in (("dense_layers", Ld, dense),
                           ("layers", L - Ld, moe)):
        if not n:
            continue
        for norm in ("ln1", "ln2"):
            out[f"{stack}/{norm}"] = ((n, D), F32, "ones")
        for name, shape in mats.items():
            out[f"{stack}/{name}"] = ((n,) + shape, bf16, "dense")
        if stack == "layers":
            out["layers/moe/router"] = ((n, D, R), F32, "dense")
    return out


def forward_flops(arch: dict, n_seqs: int, S: int) -> float:
    """The forward over n_seqs sequences of S tokens. The experts held
    here are counted at the balanced share of the routed work: T · k ·
    n_experts / router_experts rows a layer (a uniform router), whatever
    a batch's routing gives them."""
    L, D, V, F = arch["n_layers"], arch["d_model"], arch["vocab_size"], \
        arch["d_ff"]
    Ld = arch.get("first_dense_layers", 0)
    E, Fe, k = arch["n_experts"], arch["moe_d_ff"], arch["experts_per_token"]
    R = arch.get("router_experts") or E
    Fs = Fe * arch.get("n_shared_experts", 0)
    hd = arch.get("head_dim") or D // arch["n_heads"]
    Hq, Hk = arch["n_heads"], arch["n_kv_heads"]
    q, kv = Hq * hd, Hk * hd
    tokens = n_seqs * S
    attn = tokens * 2 * (D * q + 2 * D * kv + q * D) \
        + 4 * hd * Hq * counts.unmasked_pairs(S, True) * n_seqs
    dense = tokens * 2 * 3 * D * F
    moe = tokens * (2 * D * R + 2 * 3 * D * Fs) \
        + tokens * k * E / R * 2 * 3 * D * Fe
    return L * attn + Ld * dense + (L - Ld) * moe + tokens * 2 * D * V
