"""Full-model definitions of the attention-free and hybrid families
(port of ``repro.models.ssm_models``):

* rwkv6 — a stack of RWKV-6 blocks (config.rwkv=True), O(1)-state decode.
* zamba2 hybrid — Mamba2 blocks with a single SHARED attention+MLP block
  applied every ``attn_every`` layers (Zamba2's parameter-sharing trick):
  81 layers = 13 groups × (5 mamba + shared attn) + 3 trailing mamba. The
  shared block's prefill and forward attention goes through
  ``ops.flash_attention`` (at Zamba2-7B's head dim 112); its decode
  attention is the plain ``decode_attention`` over a KV cache per group,
  as in the reference.

The block weights are stacked along leading layer axes, as the reference
stacks them for ``lax.scan``; here Python loops walk the layers, each
stack unbound once a forward (``transformer.unstack``). With
``remat`` each RWKV-6 block and each Mamba2 block goes through
:func:`repro_torch.models.remat.checkpoint`, where the reference has
``jax.checkpoint``; the hybrid's shared attention block is not
rematerialized, in the reference either.

:func:`rwkv_params_from_jax` and :func:`hybrid_params_from_jax` carry the
reference's weights over bit for bit, since ``jax.random`` draws cannot be
reproduced in torch.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, dense_init, embed,
                                       embed_init, linear, rms_norm,
                                       swiglu_mlp)
from repro_torch.models.mamba2 import (Mamba2Config, Mamba2State,
                                       mamba2_apply, mamba2_init,
                                       mamba2_init_state, mamba2_param_shapes)
from repro_torch.models.mesh_ops import whole
from repro_torch.models.params_io import tree_from_numpy
from repro_torch.models.remat import checkpoint
from repro_torch.models.rwkv6 import (RWKVBlockState, RWKVConfig,
                                      rwkv_block_apply, rwkv_block_init,
                                      rwkv_init_state)
from repro_torch.models.transformer import (_decode_self, _layer, _map,
                                            _self_attention, unstack)

PARAM_DTYPE = torch.bfloat16


def rwkv_cfg_of(cfg: ArchConfig) -> RWKVConfig:
    return RWKVConfig(cfg.d_model, head_size=cfg.rwkv_head_size, d_ff=cfg.d_ff)


def rwkv_init_params(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random weights in the reference's layout, drawn on
    ``generator.device``: bfloat16 ``embed``/``lm_head``, float32 blocks
    stacked along a leading layer axis."""
    rcfg = rwkv_cfg_of(cfg)
    embed = embed_init(generator, cfg.vocab_size, cfg.d_model, PARAM_DTYPE)
    lm_head = dense_init(generator, cfg.d_model, cfg.vocab_size, PARAM_DTYPE)
    blocks = [rwkv_block_init(rcfg, generator) for _ in range(cfg.n_layers)]
    layers = {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}
    del blocks
    return {
        "embed": embed,
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=generator.device),
        "lm_head": lm_head,
        "layers": layers,
    }


def _rwkv_step(layer: dict, x: torch.Tensor,
               rcfg: RWKVConfig) -> torch.Tensor:
    return rwkv_block_apply(layer, x, rcfg)[0]


def rwkv_forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                 remat: bool = False) -> torch.Tensor:
    """(B, S) tokens → (B, S, V) logits in the compute dtype; ``remat``
    rematerializes each block in the backward."""
    rcfg = rwkv_cfg_of(cfg)
    x = embed(params["embed"].to(COMPUTE_DTYPE), tokens)
    for layer in unstack(params["layers"]):
        x = (checkpoint(_rwkv_step, layer, x, rcfg) if remat
             else _rwkv_step(layer, x, rcfg))
    x = rms_norm(x, params["final_norm"])
    return linear(x, params["lm_head"])


def rwkv_init_caches(cfg: ArchConfig, batch: int,
                     device: torch.device | str) -> RWKVBlockState:
    """Zero recurrent state of every layer, stacked along a leading layer
    axis: wkv (L, B, H, K, K), shift_tm and shift_cm (L, B, D)."""
    one = rwkv_init_state(rwkv_cfg_of(cfg), batch, device)
    return RWKVBlockState(*(t.expand((cfg.n_layers,) + tuple(t.shape))
                            for t in one))


def rwkv_decode_step(params: dict, cache: RWKVBlockState,
                     tokens: torch.Tensor, pos: Any, cfg: ArchConfig
                     ) -> tuple[torch.Tensor, RWKVBlockState]:
    """tokens (B, 1); the recurrent state is position-independent."""
    del pos
    rcfg = rwkv_cfg_of(cfg)
    x = embed(params["embed"].to(COMPUTE_DTYPE), tokens)
    states = []
    for i in range(cfg.n_layers):
        st = RWKVBlockState(*(t[i] for t in cache))
        x, st = rwkv_block_apply(_layer(params["layers"], i), x, rcfg,
                                 state=st)
        states.append(st)
    new_cache = RWKVBlockState(*(torch.stack(ts) for ts in zip(*states)))
    x = rms_norm(x, params["final_norm"])
    logits = linear(x, params["lm_head"])
    return logits, new_cache


def rwkv_param_shapes(cfg: ArchConfig) -> dict:
    """{name: (shape, dtype)} of the reference's RWKV-6 parameter tree,
    with ``layers`` a dict of stacked leaves."""
    rcfg = rwkv_cfg_of(cfg)
    D, L, F = cfg.d_model, cfg.n_layers, rcfg.ffn_dim
    H, K, R = rcfg.n_heads, rcfg.head_size, rcfg.decay_lora
    f32 = torch.float32
    layers = {
        "norm1": (D,), "norm2": (D,), "mu": (5, D), "w0": (D,),
        "w_lora_a": (D, R), "w_lora_b": (R, D), "u": (H, K),
        "wr": (D, D), "wk": (D, D), "wv": (D, D), "wg": (D, D),
        "wo": (D, D), "ln_x": (D,), "mu_ffn": (2, D),
        "wk_ffn": (D, F), "wv_ffn": (F, D), "wr_ffn": (D, D),
    }
    return {
        "embed": ((cfg.vocab_size, D), PARAM_DTYPE),
        "final_norm": ((D,), f32),
        "lm_head": ((D, cfg.vocab_size), PARAM_DTYPE),
        "layers": {k: ((L,) + s, f32) for k, s in layers.items()},
    }


def rwkv_params_from_jax(params: Mapping[str, Any], cfg: ArchConfig,
                         device: torch.device | str | None = None) -> dict:
    """The reference's RWKV-6 parameter tree, as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, repro_params)``), as the port's tensors on
    ``device`` (the card unless the caller asks for the CPU). Names,
    shapes and dtypes are checked against ``cfg``; values are copied bit
    for bit, bfloat16 leaves included."""
    return tree_from_numpy(params, rwkv_param_shapes(cfg),
                           resolve_device(device))


# ---------------------------------------------------------------------------
# Zamba2 hybrid
# ---------------------------------------------------------------------------

def mamba_cfg_of(cfg: ArchConfig) -> Mamba2Config:
    return Mamba2Config(cfg.d_model, d_state=cfg.ssm_state,
                        expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim)


def hybrid_group_shape(cfg: ArchConfig) -> tuple[int, int, int]:
    """(n_groups, mamba_per_group, n_tail): groups of (mamba × k, shared
    attn), then the tail."""
    per = cfg.attn_every
    mamba_per_group = per - 1
    n_groups = cfg.n_layers // per
    n_tail = cfg.n_layers - n_groups * per
    return n_groups, mamba_per_group, n_tail


def _shared_attn_shapes(cfg: ArchConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    bf16, f32 = PARAM_DTYPE, torch.float32
    return {"ln1": ((D,), f32), "ln2": ((D,), f32),
            "wq": ((D, cfg.q_dim), bf16), "wk": ((D, cfg.kv_dim), bf16),
            "wv": ((D, cfg.kv_dim), bf16), "wo": ((cfg.q_dim, D), bf16),
            "mlp": {"w_gate": ((D, F), bf16), "w_up": ((D, F), bf16),
                    "w_down": ((F, D), bf16)}}


def _shared_attn_init(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Unit norms; each matrix of ``_shared_attn_shapes`` a
    ``dense_init``."""
    def draw(leaf):
        shape, dtype = leaf
        if len(shape) == 1:
            return torch.ones(shape, dtype=dtype, device=generator.device)
        return dense_init(generator, *shape, dtype)

    return _map(draw, _shared_attn_shapes(cfg))


def _mamba_stack(mcfg: Mamba2Config, lead: tuple,
                 generator: torch.Generator) -> dict:
    """Blocks stacked on the leading axes ``lead``, filled one block at a
    time, so the peak is the stack plus one block."""
    n = 1
    for d in lead:
        n *= d
    stacked = {k: torch.empty((n,) + s, dtype=torch.float32,
                              device=generator.device)
               for k, s in mamba2_param_shapes(mcfg).items()}
    for i in range(n):
        for k, v in mamba2_init(mcfg, generator).items():
            stacked[k][i] = v
    return {k: v.reshape(lead + tuple(v.shape[1:]))
            for k, v in stacked.items()}


def hybrid_init_params(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random weights in the reference's layout, drawn on
    ``generator.device``: bfloat16 embeddings, head and shared block,
    float32 Mamba2 blocks stacked as (n_groups, mamba_per_group, ...) and
    the tail as (n_tail, ...)."""
    mcfg = mamba_cfg_of(cfg)
    n_groups, mpg, n_tail = hybrid_group_shape(cfg)
    params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                            PARAM_DTYPE),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=generator.device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab_size,
                              PARAM_DTYPE),
        "mamba_groups": _mamba_stack(mcfg, (n_groups, mpg), generator),
        "shared_attn": _shared_attn_init(cfg, generator),
    }
    if n_tail:
        params["mamba_tail"] = _mamba_stack(mcfg, (n_tail,), generator)
    return params


def hybrid_param_shapes(cfg: ArchConfig) -> dict:
    """{name: (shape, dtype)} of the reference's hybrid parameter tree."""
    mcfg = mamba_cfg_of(cfg)
    n_groups, mpg, n_tail = hybrid_group_shape(cfg)
    block = mamba2_param_shapes(mcfg)
    D, f32 = cfg.d_model, torch.float32
    spec = {
        "embed": ((cfg.vocab_size, D), PARAM_DTYPE),
        "final_norm": ((D,), f32),
        "lm_head": ((D, cfg.vocab_size), PARAM_DTYPE),
        "mamba_groups": {k: ((n_groups, mpg) + s, f32)
                         for k, s in block.items()},
        "shared_attn": _shared_attn_shapes(cfg),
    }
    if n_tail:
        spec["mamba_tail"] = {k: ((n_tail,) + s, f32)
                              for k, s in block.items()}
    return spec


def hybrid_params_from_jax(params: Mapping[str, Any], cfg: ArchConfig,
                           device: torch.device | str | None = None) -> dict:
    """The reference's hybrid parameter tree, as numpy arrays, as the
    port's tensors on ``device`` (the card unless the caller asks for the
    CPU). Names, shapes and dtypes are checked against ``cfg``; values are
    copied bit for bit, bfloat16 leaves included."""
    return tree_from_numpy(params, hybrid_param_shapes(cfg),
                           resolve_device(device))


def _shared_attn_apply(sa: dict, x: torch.Tensor, cfg: ArchConfig,
                       positions: torch.Tensor) -> torch.Tensor:
    """The shared attention + MLP block over (B, S, D), its attention
    through the flash kernel."""
    h = rms_norm(x, sa["ln1"], cfg.norm_eps)
    att, _ = _self_attention({"attn": sa}, h, cfg, positions)
    x = x + att
    h = rms_norm(x, sa["ln2"], cfg.norm_eps)
    m = sa["mlp"]
    return x + swiglu_mlp(h, m["w_gate"], m["w_up"], m["w_down"])


def _mamba_out(block: dict, x: torch.Tensor, mcfg: Mamba2Config,
               sharded: bool = False) -> torch.Tensor:
    return mamba2_apply(block, x, mcfg, sharded=sharded)[0]


def hybrid_forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                   remat: bool = False, sharded: bool = False
                   ) -> torch.Tensor:
    """(B, S) tokens → (B, S, V) logits in the compute dtype; ``remat``
    rematerializes each Mamba2 block in the backward (not the shared
    attention block, as the reference); ``sharded`` is each Mamba2
    block's mesh pin (``mamba2_apply``)."""
    mcfg = mamba_cfg_of(cfg)
    n_groups, mpg, _ = hybrid_group_shape(cfg)
    B, S = tokens.shape
    x = embed(params["embed"].to(COMPUTE_DTYPE), tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    if remat:
        def mamba(b, x):
            return checkpoint(_mamba_out, b, x, mcfg, sharded)
    else:
        def mamba(b, x):
            return _mamba_out(b, x, mcfg, sharded)
    blocks = unstack(params["mamba_groups"], 2)
    for g in range(n_groups):
        for b in blocks[g * mpg:(g + 1) * mpg]:
            x = x + mamba(b, x)
        x = _shared_attn_apply(params["shared_attn"], x, cfg, positions)
    if "mamba_tail" in params:
        for b in unstack(params["mamba_tail"]):
            x = x + mamba(b, x)
    x = rms_norm(x, params["final_norm"])      # the default eps, as the reference
    return linear(x, params["lm_head"])


class HybridCache(NamedTuple):
    mamba_groups: Mamba2State     # leaves lead with (n_groups, mpg, ...)
    mamba_tail: Optional[Mamba2State]
    attn_k: torch.Tensor          # (n_groups, B, S, Hk, hd)
    attn_v: torch.Tensor


def hybrid_init_cache(cfg: ArchConfig, batch: int, seq_len: int,
                      device: torch.device | str) -> HybridCache:
    """Zero Mamba2 states (float32) of every block and a zero bfloat16 KV
    cache of ``seq_len`` slots for each group's shared attention."""
    mcfg = mamba_cfg_of(cfg)
    n_groups, mpg, n_tail = hybrid_group_shape(cfg)
    one = mamba2_init_state(mcfg, batch, device)
    grouped = Mamba2State(*(t.expand((n_groups, mpg) + tuple(t.shape))
                            for t in one))
    tail = (Mamba2State(*(t.expand((n_tail,) + tuple(t.shape)) for t in one))
            if n_tail else None)
    k = torch.zeros((n_groups, batch, seq_len, cfg.n_kv_heads, cfg.hd),
                    dtype=COMPUTE_DTYPE, device=device)
    return HybridCache(grouped, tail, k, torch.zeros_like(k))


def _stack_states(states: list) -> Mamba2State:
    return Mamba2State(*(torch.stack(ts) for ts in zip(*states)))


def hybrid_decode_step(params: dict, cache: HybridCache,
                       tokens: torch.Tensor, pos: Any, cfg: ArchConfig
                       ) -> tuple[torch.Tensor, HybridCache]:
    """tokens (B, 1) at position ``pos`` → (logits (B, 1, V), cache). The
    Mamba2 states come back as new stacks (the conv state in the compute
    dtype, as the reference's); each group's new k and v are written into
    the KV cache in place, as the transformer's decode step does."""
    mcfg = mamba_cfg_of(cfg)
    n_groups, mpg, _ = hybrid_group_shape(cfg)
    pos = int(whole(pos))
    x = embed(params["embed"].to(COMPUTE_DTYPE), tokens)
    sa = params["shared_attn"]
    groups = []
    for g in range(n_groups):
        states = []
        for j in range(mpg):
            st = Mamba2State(*(t[g, j] for t in cache.mamba_groups))
            out, st = mamba2_apply(_layer(params["mamba_groups"], (g, j)),
                                   x, mcfg, state=st)
            x = x + out
            states.append(st)
        groups.append(_stack_states(states))
        h = rms_norm(x, sa["ln1"], cfg.norm_eps)
        x = x + _decode_self({"attn": sa}, h, cache.attn_k[g],
                             cache.attn_v[g], pos, cfg)
        h = rms_norm(x, sa["ln2"], cfg.norm_eps)
        m = sa["mlp"]
        x = x + swiglu_mlp(h, m["w_gate"], m["w_up"], m["w_down"])
    tail = cache.mamba_tail
    if "mamba_tail" in params:
        states = []
        for j in range(params["mamba_tail"]["norm"].shape[0]):
            st = Mamba2State(*(t[j] for t in cache.mamba_tail))
            out, st = mamba2_apply(_layer(params["mamba_tail"], j), x,
                                   mcfg, state=st)
            x = x + out
            states.append(st)
        tail = _stack_states(states)
    x = rms_norm(x, params["final_norm"])
    logits = linear(x, params["lm_head"])
    return logits, HybridCache(_stack_states(groups), tail, cache.attn_k,
                               cache.attn_v)
