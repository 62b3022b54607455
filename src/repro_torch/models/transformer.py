"""Attention-based LM families (port of ``repro.models.transformer``):
dense (Yi, StarCoder2, Qwen2.5, Mistral-Nemo), MoE (DeepSeek-MoE-16B,
Phi-3.5-MoE; the FFN is ``models.moe``), vlm (Llama-3.2-Vision: a gated
cross-attention block after every ``cross_attn_every - 1`` self-attention
layers) and audio (MusicGen: cross-attention inside every layer). The
vlm and audio families attend to a context (B, Nc, D) of precomputed
frontend embeddings; the vision encoder and the EnCodec/text frontend
are stubbed, as in the reference.

The layer weights are stacked along leading layer axes, as the reference
stacks them for ``lax.scan`` (``params["layers"]["attn"]["wq"]`` is
(L, D, q_dim); for vlm ``params["layers"]`` is (n_groups, spg, ...) and
``params["cross_layers"]`` (n_groups, ...)); here Python loops walk the
layers. Every self- and cross-attention of a prefill or forward goes
through ``ops.flash_attention`` (the flash kernel on the card; a
cross-attention with keys of their own length, Nc). Decode keeps
per-layer KV caches stacked on a leading layer axis and attends over the
whole cache, and over the context K/V the prefill computed, as the
reference.

:class:`FwdOptions` carries the reference's options by name. Its
rematerialization and its mesh levers are not ported (ROADMAP Queue 1
item 15, the mesh half): ``torch.utils.checkpoint`` does not compose with
``torch.func.grad``, which the PoFEL trainer differentiates through, and
one card has no mesh, so :func:`check_options` refuses ``remat=True`` and
any lever off its default (the MoE FFN runs the reference's ``gather``
combine). The flash kernel keeps its own tiles, so ``q_block`` and
``kv_block`` change nothing.

:func:`transformer_params_from_jax` carries the reference's weights
over bit for bit.
"""

from __future__ import annotations

import itertools
from typing import Any, Mapping, NamedTuple, Optional

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


class FwdOptions(NamedTuple):
    """The reference's forward options (``repro.models.transformer.
    FwdOptions``), fields and defaults alike; see :func:`check_options`."""
    seq_shard_axis: Optional[str] = None    # Megatron-SP residual sharding
    dp_axes: tuple = ("data",)              # batch-dim axes inside a cluster
    remat: bool = True
    q_block: int = 256
    kv_block: int = 512
    parallel_q: bool = False
    gather_kv: bool = False
    weight_gather: bool = False
    expert_axis: Optional[str] = None


# the options that only a device mesh gives meaning to
MESH_LEVERS = ("seq_shard_axis", "parallel_q", "gather_kv", "weight_gather",
               "expert_axis")


def check_options(opts: Optional[FwdOptions]) -> None:
    """Refuse what the port does not run: ``remat=True`` and any mesh
    lever off its default (ROADMAP Queue 1 item 15). None is no options,
    as ``FwdOptions(remat=False)``."""
    if opts is None:
        return
    if opts.remat:
        raise NotImplementedError(
            "FwdOptions(remat=True): rematerialization is not ported "
            "(torch.utils.checkpoint does not compose with torch.func.grad; "
            "ROADMAP Queue 1 item 15); pass FwdOptions(remat=False)")
    for name in MESH_LEVERS:
        if getattr(opts, name) != FwdOptions._field_defaults[name]:
            raise NotImplementedError(
                f"FwdOptions({name}={getattr(opts, name)!r}) is a mesh lever; "
                f"one card has no mesh (ROADMAP Queue 1 item 15)")


FAMILIES = ("dense", "moe", "vlm", "audio")
CONTEXT_FAMILIES = ("vlm", "audio")      # attend to a frontend context


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        why = NOT_PORTED.get(cfg.family, "the reference has no such family")
        raise NotImplementedError(f"{cfg.name} ({cfg.family}) is not an "
                                  f"attention family: {why}")


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def _attn_init(cfg: ArchConfig, generator: torch.Generator,
               kv_from_ctx: bool = False) -> dict:
    """q, k, v and o projections; QKV biases where the config has them,
    except on a cross-attention (k and v from the context)."""
    D = cfg.d_model
    p = {"wq": dense_init(generator, D, cfg.q_dim, PARAM_DTYPE),
         "wk": dense_init(generator, D, cfg.kv_dim, PARAM_DTYPE),
         "wv": dense_init(generator, D, cfg.kv_dim, PARAM_DTYPE),
         "wo": dense_init(generator, cfg.q_dim, D, PARAM_DTYPE)}
    if cfg.qkv_bias and not kv_from_ctx:
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
    if cfg.family == "audio":           # in-layer cross-attention (MusicGen)
        layer["ln_x"] = ones.clone()
        layer["xattn"] = _attn_init(cfg, generator, kv_from_ctx=True)
    return layer


def _cross_layer_init(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """A Llama-3.2-Vision gated cross-attention block: its tanh gates
    start at 0, so a fresh block adds nothing."""
    dev = generator.device
    ones = torch.ones((cfg.d_model,), dtype=torch.float32, device=dev)
    return {"ln1": ones, "ln2": ones.clone(),
            "xattn": _attn_init(cfg, generator, kv_from_ctx=True),
            "mlp": _mlp_init(cfg, generator),
            "gate_attn": torch.zeros((1,), dtype=torch.float32, device=dev),
            "gate_mlp": torch.zeros((1,), dtype=torch.float32, device=dev)}


def vlm_group_shape(cfg: ArchConfig) -> tuple[int, int]:
    """(n_groups, self_per_group) for interleaved cross-attention."""
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _fill(stacked: dict, i, layer: dict) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _fill(stacked[k], i, v)
        else:
            stacked[k][i] = v


def _stacked(lead: tuple, draw) -> dict:
    """``draw()`` once for each index of the leading axes ``lead``, the
    layers stacked along them (filled one layer at a time, so the peak is
    the stack plus one layer)."""
    stacked = None
    for i in itertools.product(*map(range, lead)):
        layer = draw()
        if stacked is None:
            stacked = _map(lambda t: t.new_empty(lead + tuple(t.shape)),
                           layer)
        _fill(stacked, i, layer)
    return stacked


def init_params(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random weights in the reference's layout, drawn on
    ``generator.device``: bfloat16 matrices, float32 norms, gates (and MoE
    router), the layers stacked along leading layer axes."""
    _check_family(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    params = {
        "embed": embed_init(generator, V, D, PARAM_DTYPE),
        "final_norm": torch.ones((D,), dtype=torch.float32,
                                 device=generator.device),
        "lm_head": dense_init(generator, D, V, PARAM_DTYPE),
    }
    if cfg.family == "vlm":
        n_groups, spg = vlm_group_shape(cfg)
        params["layers"] = _stacked(
            (n_groups, spg), lambda: _self_layer_init(cfg, generator))
        params["cross_layers"] = _stacked(
            (n_groups,), lambda: _cross_layer_init(cfg, generator))
    else:
        params["layers"] = _stacked(
            (cfg.n_layers,), lambda: _self_layer_init(cfg, generator))
    return params


def _attn_shapes(cfg: ArchConfig, kv_from_ctx: bool = False) -> dict:
    D, bf16 = cfg.d_model, PARAM_DTYPE
    attn = {"wq": ((D, cfg.q_dim), bf16), "wk": ((D, cfg.kv_dim), bf16),
            "wv": ((D, cfg.kv_dim), bf16), "wo": ((cfg.q_dim, D), bf16)}
    if cfg.qkv_bias and not kv_from_ctx:
        attn.update(bq=((cfg.q_dim,), bf16), bk=((cfg.kv_dim,), bf16),
                    bv=((cfg.kv_dim,), bf16))
    return attn


def _mlp_shapes(cfg: ArchConfig) -> dict:
    D, F, bf16 = cfg.d_model, cfg.d_ff, PARAM_DTYPE
    return {"w_gate": ((D, F), bf16), "w_up": ((D, F), bf16),
            "w_down": ((F, D), bf16)}


def _lead(lead: tuple, spec: dict) -> dict:
    """``spec`` with the leading axes ``lead`` put before every shape."""
    return _map(lambda sd: (lead + sd[0], sd[1]), spec)


def param_shapes(cfg: ArchConfig) -> dict:
    """{name: (shape, dtype)} of the reference's parameter tree of an
    attention family: ``layers`` holding the leaves stacked on a leading
    layer axis, or for vlm on (n_groups, spg) axes beside
    ``cross_layers`` on an (n_groups,) axis."""
    _check_family(cfg)
    D = cfg.d_model
    norm = ((D,), torch.float32)
    layer = {"ln1": norm, "ln2": norm, "attn": _attn_shapes(cfg)}
    if cfg.family == "moe":
        layer["moe"] = _moe_shapes(cfg)
    else:
        layer["mlp"] = _mlp_shapes(cfg)
    if cfg.family == "audio":
        layer.update(ln_x=norm, xattn=_attn_shapes(cfg, kv_from_ctx=True))
    spec = {
        "embed": ((cfg.vocab_size, D), PARAM_DTYPE),
        "final_norm": norm,
        "lm_head": ((D, cfg.vocab_size), PARAM_DTYPE),
    }
    if cfg.family == "vlm":
        n_groups, spg = vlm_group_shape(cfg)
        gate = ((1,), torch.float32)
        cross = {"ln1": norm, "ln2": norm,
                 "xattn": _attn_shapes(cfg, kv_from_ctx=True),
                 "mlp": _mlp_shapes(cfg), "gate_attn": gate,
                 "gate_mlp": gate}
        spec["layers"] = _lead((n_groups, spg), layer)
        spec["cross_layers"] = _lead((n_groups,), cross)
    else:
        spec["layers"] = _lead((cfg.n_layers,), layer)
    return spec


def transformer_params_from_jax(params: Mapping[str, Any], cfg: ArchConfig,
                                device: torch.device | str | None = None
                                ) -> dict:
    """The reference's parameter tree of an attention family (the vlm
    ``cross_layers`` and the audio ``xattn`` included), as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, repro_params)``), as the port's tensors on
    ``device`` (the card unless the caller asks for the CPU). Names,
    shapes and dtypes are checked against ``cfg``; values are copied bit
    for bit, bfloat16 leaves included."""
    return tree_from_numpy(params, param_shapes(cfg), resolve_device(device))


def _layer(layers: dict, i) -> dict:
    """The layer at index ``i`` (an int, or a (group, j) tuple) of a
    stack."""
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


def _cross_attention(a: dict, x: torch.Tensor, ctx_kv: tuple,
                     cfg: ArchConfig) -> torch.Tensor:
    """Attend from x (B, S, D) to the precomputed context K/V, each
    (B, Nc, Hk, hd): flash attention with keys of their own length,
    unmasked, positions from 0 (no RoPE on either side)."""
    B, S, _ = x.shape
    k, v = ctx_kv
    q = (x @ a["wq"].to(x.dtype)).reshape(B, S, cfg.n_heads, cfg.hd)
    o = blockwise_attention(q, k, v, causal=False, window=0)
    return o.reshape(B, S, cfg.q_dim) @ a["wo"].to(x.dtype)


def _context_kv(xattn: dict, context: torch.Tensor,
                cfg: ArchConfig) -> tuple:
    """The context (B, Nc, D) → its K and V, each (B, Nc, Hk, hd)."""
    B, Nc, _ = context.shape
    k = context @ xattn["wk"].to(context.dtype)
    v = context @ xattn["wv"].to(context.dtype)
    return (k.reshape(B, Nc, cfg.n_kv_heads, cfg.hd),
            v.reshape(B, Nc, cfg.n_kv_heads, cfg.hd))


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
                positions: torch.Tensor,
                ctx_kv: Optional[tuple] = None) -> tuple:
    h = rms_norm(x, layer["ln1"], cfg.norm_eps)
    att, kv = _self_attention(layer, h, cfg, positions)
    x = x + att
    if ctx_kv is not None:          # MusicGen's in-layer cross-attention
        h = rms_norm(x, layer["ln_x"], cfg.norm_eps)
        x = x + _cross_attention(layer["xattn"], h, ctx_kv, cfg)
    h = rms_norm(x, layer["ln2"], cfg.norm_eps)
    f, aux = _ffn(layer, h, cfg)
    return x + f, aux, kv


def _gated(gate: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.tanh(gate.to(torch.float32)).to(y.dtype) * y


def _cross_block(block: dict, x: torch.Tensor, cfg: ArchConfig,
                 attend) -> torch.Tensor:
    """Llama-3.2-Vision's gated cross-attention block; ``attend(xattn,
    h)`` is its attention to the context (flash over the whole sequence,
    or one decode step over the cached context K/V)."""
    h = rms_norm(x, block["ln1"], cfg.norm_eps)
    x = x + _gated(block["gate_attn"], attend(block["xattn"], h))
    h = rms_norm(x, block["ln2"], cfg.norm_eps)
    m = block["mlp"]
    return x + _gated(block["gate_mlp"],
                      swiglu_mlp(h, m["w_gate"], m["w_up"], m["w_down"]))


def _self_layer_index(cfg: ArchConfig) -> list:
    """The index of each self-attention layer in ``params["layers"]``, in
    the order they run: i, or (group, j) for vlm."""
    if cfg.family == "vlm":
        return list(itertools.product(*map(range, vlm_group_shape(cfg))))
    return list(range(cfg.n_layers))


def _require_context(cfg: ArchConfig, context) -> None:
    if context is None:
        raise ValueError(f"{cfg.name} ({cfg.family}) needs its context "
                         f"embeddings (B, {cfg.n_context_tokens}, "
                         f"{cfg.d_model})")


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            context: Optional[torch.Tensor] = None,
            collect_cache: bool = False):
    """tokens (B, S) → (logits (B, S, V), the MoE aux loss summed over
    the layers (), 0 for the other families) and, when ``collect_cache``,
    a :class:`DecodeCache` for prefill: the stacked per-layer
    self-attention (k, v), each (L, B, S, Hk, hd), and with a context each
    cross-attention layer's context (k, v), each (Lc, B, Nc, Hk, hd), as
    the forward computed them.

    context: (B, Nc, D) precomputed frontend embeddings. vlm raises
    without it (the reference asserts); audio without it runs its
    self-attention only, as the reference does."""
    _check_family(cfg)
    if cfg.family == "vlm":
        _require_context(cfg, context)
    B, S = tokens.shape
    x = params["embed"].to(COMPUTE_DTYPE)[tokens.long()]
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs, cks, cvs = [], [], [], []
    spg = vlm_group_shape(cfg)[1] if cfg.family == "vlm" else 0
    for i in _self_layer_index(cfg):
        layer = _layer(params["layers"], i)
        ctx_kv = None
        if cfg.family == "audio" and context is not None:
            ctx_kv = _context_kv(layer["xattn"], context, cfg)
        x, aux_l, (k, v) = _self_block(layer, x, cfg, positions, ctx_kv)
        aux = aux + aux_l
        if spg and i[1] == spg - 1:           # the group's cross block
            block = _layer(params["cross_layers"], i[0])
            ctx_kv = _context_kv(block["xattn"], context, cfg)
            x = _cross_block(block, x, cfg, lambda xa, h: _cross_attention(
                xa, h, ctx_kv, cfg))
        if collect_cache:
            ks.append(k)
            vs.append(v)
            if ctx_kv is not None:
                cks.append(ctx_kv[0])
                cvs.append(ctx_kv[1])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    if collect_cache:
        return logits, aux, DecodeCache(
            torch.stack(ks), torch.stack(vs),
            torch.stack(cks) if cks else None,
            torch.stack(cvs) if cvs else None)
    return logits, aux


# ---------------------------------------------------------------------------
# Decode (single-token serve step with KV caches)
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    k: torch.Tensor          # (L, B, S, Hk, hd) stacked self-attention K
    v: torch.Tensor
    ctx_k: Optional[torch.Tensor] = None   # (Lc, B, Nc, Hk, hd) context K
    ctx_v: Optional[torch.Tensor] = None


def _cache_layers(cfg: ArchConfig) -> tuple[int, int]:
    """(self-attention layers L, cross-attention layers Lc)."""
    if cfg.family == "vlm":
        n_groups, spg = vlm_group_shape(cfg)
        return n_groups * spg, n_groups
    if cfg.family == "audio":
        return cfg.n_layers, cfg.n_layers
    return cfg.n_layers, 0


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               device: torch.device | str,
               dtype: torch.dtype = COMPUTE_DTYPE) -> DecodeCache:
    """Zero self-attention K/V of ``seq_len`` slots and, for vlm and
    audio, zero context K/V of Nc slots (the prefill fills them)."""
    _check_family(cfg)
    L, Lc = _cache_layers(cfg)

    def zeros(n, s):
        return torch.zeros((n, batch, s, cfg.n_kv_heads, cfg.hd),
                           dtype=dtype, device=device)

    if Lc:
        return DecodeCache(zeros(L, seq_len), zeros(L, seq_len),
                           zeros(Lc, cfg.n_context_tokens),
                           zeros(Lc, cfg.n_context_tokens))
    return DecodeCache(zeros(L, seq_len), zeros(L, seq_len))


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


def _decode_cross(xattn: dict, x: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x (B, 1, D) attending to every slot of the context K/V ck, cv
    (B, Nc, Hk, hd) → (B, 1, D)."""
    B = x.shape[0]
    q = (x @ xattn["wq"].to(x.dtype)).reshape(B, 1, cfg.n_heads, cfg.hd)
    o = decode_attention(q, ck, cv, ck.shape[1] - 1, window=0)
    return o.reshape(B, 1, cfg.q_dim) @ xattn["wo"].to(x.dtype)


def decode_step(params: dict, cache: DecodeCache, tokens: torch.Tensor,
                pos: int, cfg: ArchConfig) -> tuple[torch.Tensor, DecodeCache]:
    """One serve step: tokens (B, 1) at position ``pos`` → (logits
    (B, 1, V), cache). The reference returns an updated copy of the cache;
    here the new k and v are written into ``cache`` in place, which saves
    a copy of the whole cache a step, and the same cache is returned. The
    context K/V are read, never written."""
    _check_family(cfg)
    pos = int(pos)
    x = params["embed"].to(COMPUTE_DTYPE)[tokens.long()]
    spg = vlm_group_shape(cfg)[1] if cfg.family == "vlm" else 0
    for c, i in enumerate(_self_layer_index(cfg)):
        layer = _layer(params["layers"], i)
        h = rms_norm(x, layer["ln1"], cfg.norm_eps)
        x = x + _decode_self(layer, h, cache.k[c], cache.v[c], pos, cfg)
        if cfg.family == "audio":
            h = rms_norm(x, layer["ln_x"], cfg.norm_eps)
            x = x + _decode_cross(layer["xattn"], h, cache.ctx_k[c],
                                  cache.ctx_v[c], cfg)
        h = rms_norm(x, layer["ln2"], cfg.norm_eps)
        x = x + _ffn(layer, h, cfg)[0]
        if spg and i[1] == spg - 1:           # the group's cross block
            g = i[0]
            x = _cross_block(
                _layer(params["cross_layers"], g), x, cfg,
                lambda xa, h: _decode_cross(xa, h, cache.ctx_k[g],
                                            cache.ctx_v[g], cfg))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype), cache


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            context: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, DecodeCache]:
    """Run the full sequence once, collecting the per-layer K/V into a
    prompt-sized cache, plus the last position's logits (B, 1, V). vlm
    and audio need the context (B, Nc, D): the cache then also holds each
    cross-attention layer's context K/V, (Lc, B, Nc, Hk, hd)."""
    if cfg.family in CONTEXT_FAMILIES:
        _require_context(cfg, context)
    logits, _, kv = forward(params, tokens, cfg, context=context,
                            collect_cache=True)
    cache = DecodeCache(*(None if t is None else t.to(COMPUTE_DTYPE)
                          for t in kv))
    return logits[:, -1:], cache
