"""Attention-based LM families (port of ``repro.models.transformer``), so
far the dense family (Yi, StarCoder2, Qwen2.5, Mistral-Nemo) and the MoE
family (DeepSeek-MoE-16B, Phi-3.5-MoE), whose FFN is ``models.moe``.

The layer weights are stacked along a leading layer axis, as the
reference stacks them for ``lax.scan`` (``params["layers"]["attn"]["wq"]``
is (L, D, q_dim)); here a Python loop walks the layers. Every layer's
prefill and forward attention goes through ``ops.flash_attention`` (the
flash kernel on the card). Decode keeps per-layer KV caches stacked on a
leading layer axis and attends over the whole cache, as the reference.

Not ported: the VLM and audio cross-attention (ROADMAP Queue 1 item
11c), the reference's rematerialization and its mesh levers in
``FwdOptions`` (Queue 1 item 15; the MoE FFN runs the reference's
``gather`` combine).

:func:`transformer_params_from_jax` carries the reference's weights
over bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import NOT_PORTED
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, apply_rope,
                                       blockwise_attention, decode_attention,
                                       dense_init, embed_init, rms_norm,
                                       swiglu_mlp)
from repro_torch.models.moe import MoEConfig, moe_ffn
from repro_torch.models.params_io import tree_from_numpy

PARAM_DTYPE = torch.bfloat16


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported to repro_torch yet: "
            f"{NOT_PORTED.get(cfg.family, 'ROADMAP Queue 1 item 11')}")


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def _attn_init(cfg: ArchConfig, generator: torch.Generator) -> dict:
    D = cfg.d_model
    p = {"wq": dense_init(generator, D, cfg.q_dim, PARAM_DTYPE),
         "wk": dense_init(generator, D, cfg.kv_dim, PARAM_DTYPE),
         "wv": dense_init(generator, D, cfg.kv_dim, PARAM_DTYPE),
         "wo": dense_init(generator, cfg.q_dim, D, PARAM_DTYPE)}
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=PARAM_DTYPE, device=dev)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=PARAM_DTYPE, device=dev)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=PARAM_DTYPE, device=dev)
    return p


def _mlp_init(cfg: ArchConfig, generator: torch.Generator) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {"w_gate": dense_init(generator, D, F, PARAM_DTYPE),
            "w_up": dense_init(generator, D, F, PARAM_DTYPE),
            "w_down": dense_init(generator, F, D, PARAM_DTYPE)}


def _moe_shapes(cfg: ArchConfig) -> dict:
    """{name: (shape, dtype)} of one layer's MoE FFN: a float32 router,
    the (E, ·, ·) bfloat16 expert stacks and the shared experts."""
    D, E = cfg.d_model, cfg.n_experts
    Fe = cfg.moe_d_ff or cfg.d_ff
    bf16 = PARAM_DTYPE
    spec = {"router": ((D, E), torch.float32),
            "w_gate": ((E, D, Fe), bf16), "w_up": ((E, D, Fe), bf16),
            "w_down": ((E, Fe, D), bf16)}
    if cfg.n_shared_experts:
        Fs = Fe * cfg.n_shared_experts
        spec["shared"] = {"w_gate": ((D, Fs), bf16), "w_up": ((D, Fs), bf16),
                          "w_down": ((Fs, D), bf16)}
    return spec


def _moe_init(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Each matrix of ``_moe_shapes`` a ``dense_init``; an (E, ·, ·)
    expert stack one expert at a time."""
    def draw(leaf):
        shape, dtype = leaf
        if len(shape) == 2:
            return dense_init(generator, *shape, dtype)
        out = torch.empty(shape, dtype=dtype, device=generator.device)
        for e in range(shape[0]):
            out[e] = dense_init(generator, *shape[1:], dtype)
        return out

    return _map(draw, _moe_shapes(cfg))


def _self_layer_init(cfg: ArchConfig, generator: torch.Generator) -> dict:
    ones = torch.ones((cfg.d_model,), dtype=torch.float32,
                      device=generator.device)
    layer = {"ln1": ones, "ln2": ones.clone(),
             "attn": _attn_init(cfg, generator)}
    if cfg.family == "moe":
        layer["moe"] = _moe_init(cfg, generator)
    else:
        layer["mlp"] = _mlp_init(cfg, generator)
    return layer


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _fill(stacked: dict, i: int, layer: dict) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _fill(stacked[k], i, v)
        else:
            stacked[k][i] = v


def init_params(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random weights in the reference's layout, drawn on
    ``generator.device``: bfloat16 matrices, float32 norms (and MoE
    router), the layers stacked along a leading layer axis (filled one
    layer at a time, so the peak is the model plus one layer)."""
    _check_family(cfg)
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    params = {
        "embed": embed_init(generator, V, D, PARAM_DTYPE),
        "final_norm": torch.ones((D,), dtype=torch.float32,
                                 device=generator.device),
        "lm_head": dense_init(generator, D, V, PARAM_DTYPE),
    }
    stacked = None
    for i in range(L):
        layer = _self_layer_init(cfg, generator)
        if stacked is None:
            stacked = _map(lambda t: t.new_empty((L,) + tuple(t.shape)),
                           layer)
        _fill(stacked, i, layer)
    params["layers"] = stacked
    return params


def param_shapes(cfg: ArchConfig) -> dict:
    """{name: (shape, dtype)} of the reference's dense or MoE parameter
    tree, ``layers`` holding the leaves stacked on a leading layer axis."""
    _check_family(cfg)
    D, L, F = cfg.d_model, cfg.n_layers, cfg.d_ff
    attn = {"wq": (D, cfg.q_dim), "wk": (D, cfg.kv_dim),
            "wv": (D, cfg.kv_dim), "wo": (cfg.q_dim, D)}
    if cfg.qkv_bias:
        attn.update(bq=(cfg.q_dim,), bk=(cfg.kv_dim,), bv=(cfg.kv_dim,))
    bf16 = PARAM_DTYPE
    layers = {
        "ln1": ((L, D), torch.float32), "ln2": ((L, D), torch.float32),
        "attn": {k: ((L,) + s, bf16) for k, s in attn.items()},
    }
    if cfg.family == "moe":
        layers["moe"] = _map(lambda sd: ((L,) + sd[0], sd[1]),
                             _moe_shapes(cfg))
    else:
        mlp = {"w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}
        layers["mlp"] = {k: ((L,) + s, bf16) for k, s in mlp.items()}
    return {
        "embed": ((cfg.vocab_size, D), bf16),
        "final_norm": ((D,), torch.float32),
        "lm_head": ((D, cfg.vocab_size), bf16),
        "layers": layers,
    }


def transformer_params_from_jax(params: Mapping[str, Any], cfg: ArchConfig,
                                device: torch.device | str | None = None
                                ) -> dict:
    """The reference's dense or MoE parameter tree, as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, repro_params)``), as the port's tensors on
    ``device`` (the card unless the caller asks for the CPU). Names,
    shapes and dtypes are checked against ``cfg``; values are copied bit
    for bit, bfloat16 leaves included."""
    return tree_from_numpy(params, param_shapes(cfg), resolve_device(device))


def _layer(layers: dict, i: int) -> dict:
    return _map(lambda t: t[i], layers)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _project_qkv(a: dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor) -> tuple:
    """x (B, S, D) → q (B, S, Hq, hd), k and v (B, S, Hk, hd), q and k
    rotated to ``positions`` (B, S)."""
    B, S, _ = x.shape
    q = x @ a["wq"].to(x.dtype)
    k = x @ a["wk"].to(x.dtype)
    v = x @ a["wv"].to(x.dtype)
    if "bq" in a:
        q = q + a["bq"].to(q.dtype)
        k = k + a["bk"].to(k.dtype)
        v = v + a["bv"].to(v.dtype)
    q = apply_rope(q.reshape(B, S, cfg.n_heads, cfg.hd), positions,
                   cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, cfg.n_kv_heads, cfg.hd), positions,
                   cfg.rope_theta)
    return q, k, v.reshape(B, S, cfg.n_kv_heads, cfg.hd)


def _self_attention(layer: dict, x: torch.Tensor, cfg: ArchConfig,
                    positions: torch.Tensor) -> tuple:
    """(attention output (B, S, D), (k, v) for the cache)."""
    B, S, _ = x.shape
    a = layer["attn"]
    q, k, v = _project_qkv(a, x, cfg, positions)
    o = blockwise_attention(q, k, v, causal=True, window=cfg.sliding_window)
    out = o.reshape(B, S, cfg.q_dim) @ a["wo"].to(x.dtype)
    return out, (k, v)


def _ffn(layer: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple:
    """(out, the MoE load-balancing loss ()): the MoE FFN over the
    (B·S, D) tokens, or the dense SwiGLU MLP and a zero loss."""
    if cfg.family == "moe":
        B, S, D = x.shape
        moe_cfg = MoEConfig(cfg.n_experts, cfg.experts_per_token,
                            cfg.capacity_factor)
        out, aux = moe_ffn(x.reshape(B * S, D), layer["moe"], moe_cfg)
        return out.reshape(B, S, D), aux
    m = layer["mlp"]
    return (swiglu_mlp(x, m["w_gate"], m["w_up"], m["w_down"]),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _self_block(layer: dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor) -> tuple:
    h = rms_norm(x, layer["ln1"], cfg.norm_eps)
    att, kv = _self_attention(layer, h, cfg, positions)
    x = x + att
    h = rms_norm(x, layer["ln2"], cfg.norm_eps)
    f, aux = _ffn(layer, h, cfg)
    return x + f, aux, kv


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            collect_cache: bool = False):
    """tokens (B, S) → (logits (B, S, V), the MoE aux loss summed over
    the layers (), 0 for the dense family) and, when ``collect_cache``,
    the stacked per-layer (k, v), each (L, B, S, Hk, hd), for prefill."""
    _check_family(cfg)
    B, S = tokens.shape
    x = params["embed"].to(COMPUTE_DTYPE)[tokens.long()]
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, aux_l, (k, v) = _self_block(_layer(params["layers"], i), x, cfg,
                                       positions)
        aux = aux + aux_l
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    if collect_cache:
        return logits, aux, (torch.stack(ks), torch.stack(vs))
    return logits, aux


# ---------------------------------------------------------------------------
# Decode (single-token serve step with KV caches)
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    k: torch.Tensor          # (L, B, S, Hk, hd) stacked self-attention K
    v: torch.Tensor


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               device: torch.device | str,
               dtype: torch.dtype = COMPUTE_DTYPE) -> DecodeCache:
    _check_family(cfg)
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.hd)
    return DecodeCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


def _decode_self(layer: dict, x: torch.Tensor, kc: torch.Tensor,
                 vc: torch.Tensor, pos: int, cfg: ArchConfig) -> torch.Tensor:
    """x (B, 1, D); kc, vc (B, S, Hk, hd), this token's k and v written at
    slot ``pos`` in place. Returns the attention output (B, 1, D)."""
    B = x.shape[0]
    a = layer["attn"]
    pvec = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(a, x, cfg, pvec)
    kc[:, pos] = k[:, 0].to(kc.dtype)
    vc[:, pos] = v[:, 0].to(vc.dtype)
    o = decode_attention(q, kc, vc, pos, window=cfg.sliding_window)
    return o.reshape(B, 1, cfg.q_dim) @ a["wo"].to(x.dtype)


def decode_step(params: dict, cache: DecodeCache, tokens: torch.Tensor,
                pos: int, cfg: ArchConfig) -> tuple[torch.Tensor, DecodeCache]:
    """One serve step: tokens (B, 1) at position ``pos`` → (logits
    (B, 1, V), cache). The reference returns an updated copy of the cache;
    here the new k and v are written into ``cache`` in place, which saves
    a copy of the whole cache a step, and the same cache is returned."""
    _check_family(cfg)
    pos = int(pos)
    x = params["embed"].to(COMPUTE_DTYPE)[tokens.long()]
    for i in range(cfg.n_layers):
        layer = _layer(params["layers"], i)
        h = rms_norm(x, layer["ln1"], cfg.norm_eps)
        x = x + _decode_self(layer, h, cache.k[i], cache.v[i], pos, cfg)
        h = rms_norm(x, layer["ln2"], cfg.norm_eps)
        x = x + _ffn(layer, h, cfg)[0]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype), cache


def prefill(params: dict, tokens: torch.Tensor,
            cfg: ArchConfig) -> tuple[torch.Tensor, DecodeCache]:
    """Run the full sequence once, collecting the per-layer K/V into a
    prompt-sized cache, plus the last position's logits (B, 1, V)."""
    logits, _, (ks, vs) = forward(params, tokens, cfg, collect_cache=True)
    return logits[:, -1:], DecodeCache(ks.to(COMPUTE_DTYPE),
                                       vs.to(COMPUTE_DTYPE))
