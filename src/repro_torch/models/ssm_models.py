"""Full-model definitions of the attention-free families (port of
``repro.models.ssm_models``), so far RWKV-6 only: a stack of RWKV-6
blocks (config.rwkv=True) with O(1)-state decode. The Zamba2 hybrid
is not ported (ROADMAP Queue 1 item 11).

The block weights are stacked along a leading layer axis, as the
reference stacks them for ``lax.scan``; here a Python loop walks the
layers. The slice is forward only, so there is no rematerialization.

:func:`rwkv_params_from_jax` carries the reference's weights over bit
for bit, since ``jax.random`` draws cannot be reproduced in torch.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, dense_init, embed_init,
                                       rms_norm)
from repro_torch.models.params_io import tree_from_numpy
from repro_torch.models.rwkv6 import (RWKVBlockState, RWKVConfig,
                                      rwkv_block_apply, rwkv_block_init,
                                      rwkv_init_state)

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


def _layer(layers: dict, i: int) -> dict:
    return {k: v[i] for k, v in layers.items()}


def rwkv_forward(params: dict, tokens: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """(B, S) tokens → (B, S, V) logits in the compute dtype."""
    rcfg = rwkv_cfg_of(cfg)
    x = params["embed"].to(COMPUTE_DTYPE)[tokens.long()]
    for i in range(cfg.n_layers):
        x, _ = rwkv_block_apply(_layer(params["layers"], i), x, rcfg)
    x = rms_norm(x, params["final_norm"])
    return x @ params["lm_head"].to(x.dtype)


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
    x = params["embed"].to(COMPUTE_DTYPE)[tokens.long()]
    states = []
    for i in range(cfg.n_layers):
        st = RWKVBlockState(*(t[i] for t in cache))
        x, st = rwkv_block_apply(_layer(params["layers"], i), x, rcfg,
                                 state=st)
        states.append(st)
    new_cache = RWKVBlockState(*(torch.stack(ts) for ts in zip(*states)))
    x = rms_norm(x, params["final_norm"])
    logits = x @ params["lm_head"].to(x.dtype)
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
