"""Analytic FLOP / HBM-byte estimators per (arch × step kind) (port of
``repro.launch.costs``, formula for formula, on the port's ``Model``).

The roofline's compute and memory terms come from these documented
formulas: the port's models loop over their layers in Python and are
not compiled into one program whose cost could be read back.

All results are GLOBAL (whole-step, all devices); the roofline divides by
device count × per-device rates (``repro_torch.launch.roofline``).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.shapes import InputShape
from repro_torch.models.config import ArchConfig
from repro_torch.models.model_api import Model

BF16 = 2
F32 = 4


@dataclass
class StepCost:
    flops: float          # global FLOPs per step
    hbm_bytes: float      # global HBM traffic per step
    notes: str = ""


def _attention_flops(cfg: ArchConfig, batch: int, seq: int, kv_len: int,
                     n_attn_layers: int) -> float:
    """QK^T + PV: 4·B·L·Hq·hd·Sq·Skv. Our blockwise implementation computes
    the full rectangle and masks (no causal skipping) — counted as built."""
    return 4.0 * batch * n_attn_layers * cfg.n_heads * cfg.hd * seq * kv_len


def _recurrence_flops(cfg: ArchConfig, batch: int, seq: int) -> float:
    """rwkv6 wkv (≈6·H·K² per token-layer) / mamba2 SSD (≈6·H·P·N)."""
    if cfg.rwkv:
        H = cfg.d_model // cfg.rwkv_head_size
        K = cfg.rwkv_head_size
        return 6.0 * batch * seq * cfg.n_layers * H * K * K
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_head_dim
        n_mamba = cfg.n_layers - cfg.n_layers // cfg.attn_every
        return 6.0 * batch * seq * n_mamba * H * cfg.ssm_head_dim * cfg.ssm_state
    return 0.0


def _n_attn_layers(cfg: ArchConfig) -> int:
    if cfg.rwkv:
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def _cross_attn_flops(cfg: ArchConfig, batch: int, seq: int) -> float:
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
    elif cfg.family == "audio":
        n_cross = cfg.n_layers
    else:
        return 0.0
    return 4.0 * batch * n_cross * cfg.n_heads * cfg.hd * seq * cfg.n_context_tokens


def forward_cost(model: Model, batch: int, seq: int) -> StepCost:
    """One full-sequence forward pass."""
    cfg = model.cfg
    n_active = model.n_active_params()
    tokens = batch * seq
    matmul = 2.0 * n_active * tokens
    kv_len = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    attn = _attention_flops(cfg, batch, seq, kv_len, _n_attn_layers(cfg))
    attn += _cross_attn_flops(cfg, batch, seq)
    rec = _recurrence_flops(cfg, batch, seq)
    flops = matmul + attn + rec

    p_bytes = model.n_params() * BF16
    act_bytes = tokens * cfg.d_model * BF16 * cfg.n_layers * 2   # write+read
    attn_kv_bytes = (tokens * cfg.n_kv_heads * cfg.hd * 2 * BF16
                     * _n_attn_layers(cfg))
    logits_bytes = tokens * cfg.vocab_size * BF16 * 2
    return StepCost(flops, p_bytes + act_bytes + attn_kv_bytes + logits_bytes)


def train_cost(model: Model, shape: InputShape, n_clusters: int,
               remat: bool = True) -> StepCost:
    """PoFEL round: per-cluster FedSGD (fwd + 2×bwd + remat fwd) on the full
    global batch, plus consensus (Eq. 1 aggregation + Eq. 2 similarity) and
    the redistribution broadcast."""
    fwd = forward_cost(model, shape.global_batch, shape.seq_len)
    mult = 4.0 if remat else 3.0
    n_params = model.n_params()
    consensus_flops = (2.0 + 6.0) * n_clusters * n_params  # Eq.1 + Eq.2
    inner_sgd = 2.0 * n_clusters * n_params
    flops = fwd.flops * mult + consensus_flops + inner_sgd

    # weights traffic: each cluster reads its own copy fwd+bwd+remat and
    # writes the update; grads transient; consensus reads all C copies once.
    p_bytes = n_params * BF16
    weight_traffic = n_clusters * p_bytes * (mult + 2.0)
    act_traffic = fwd.hbm_bytes - p_bytes  # activations dominate
    hbm = weight_traffic + act_traffic * (mult - 1.0)
    return StepCost(flops, hbm, "fwd+bwd+remat ×C clusters + consensus")


def prefill_cost(model: Model, shape: InputShape) -> StepCost:
    c = forward_cost(model, shape.global_batch, shape.seq_len)
    # + KV-cache write
    cfg = model.cfg
    kv_write = (shape.global_batch * shape.seq_len * cfg.n_kv_heads * cfg.hd
                * 2 * BF16 * _n_attn_layers(cfg))
    return StepCost(c.flops, c.hbm_bytes + kv_write, "prefill")


def decode_cost(model: Model, shape: InputShape) -> StepCost:
    """One token for the whole batch against a seq_len cache."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    n_active = model.n_active_params()
    matmul = 2.0 * n_active * B
    kv_len = min(S, cfg.sliding_window) if cfg.sliding_window else S
    attn = _attention_flops(cfg, B, 1, kv_len, _n_attn_layers(cfg))
    attn += _cross_attn_flops(cfg, B, 1)
    rec = _recurrence_flops(cfg, B, 1)

    p_bytes = model.n_params() * BF16          # weights read once (batched)
    kv_read = (B * kv_len * cfg.n_kv_heads * cfg.hd * 2 * BF16
               * _n_attn_layers(cfg))
    if cfg.rwkv:
        H = cfg.d_model // cfg.rwkv_head_size
        K = cfg.rwkv_head_size
        kv_read = B * cfg.n_layers * H * K * K * F32 * 2
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_head_dim
        n_mamba = cfg.n_layers - cfg.n_layers // cfg.attn_every
        kv_read += B * n_mamba * H * cfg.ssm_head_dim * cfg.ssm_state * F32 * 2
    return StepCost(matmul + attn + rec, p_bytes + kv_read, "decode")


def step_cost(model: Model, shape: InputShape, n_clusters: int = 8) -> StepCost:
    if shape.kind == "train":
        return train_cost(model, shape, n_clusters)
    if shape.kind == "prefill":
        return prefill_cost(model, shape)
    return decode_cost(model, shape)
