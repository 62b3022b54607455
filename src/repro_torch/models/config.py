"""Unified architecture config for the assigned model pool.

A copy of ``repro.models.config`` (pure Python), so the port imports
nothing of the reference package, with the fields of :data:`PORT_ONLY`
besides."""

from __future__ import annotations

from dataclasses import dataclass, replace


# fields the reference's ArchConfig lacks, at the values that leave a
# configuration as the reference has it (an expert-parallel chip's share
# and DeepSeek-MoE's dense first layer and ungated top-k)
PORT_ONLY = {"router_experts": 0, "first_dense_layers": 0, "norm_topk": True}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 → d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0           # per-expert FFN dim (fine-grained); 0 → d_ff
    capacity_factor: float = 1.25   # 0: dropless (every held assignment)
    router_experts: int = 0     # the router's width; 0 → n_experts. More
                                # than n_experts: this chip holds experts
                                # [0, n_experts) of an expert-parallel layer
    first_dense_layers: int = 0  # leading layers with a dense SwiGLU (d_ff)
    norm_topk: bool = True      # renormalize the top-k gates to sum to 1
    # cross-attention context (VLM image patches / audio conditioning)
    cross_attn_every: int = 0   # 0 none; 1 in-layer every layer; k interleaved
    n_context_tokens: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0         # hybrid: shared attention block period
    rwkv: bool = False
    rwkv_head_size: int = 64
    # serving
    sliding_window: int = 0     # 0 = full attention
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_router(self) -> int:
        return self.router_experts or self.n_experts

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    def with_sliding_window(self, window: int) -> "ArchConfig":
        return replace(self, sliding_window=window)

    def reduced(self, n_layers: int = 2, d_model: int = 256, n_experts: int = 4,
                vocab: int = 512) -> "ArchConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        hd = 32
        n_heads = max(2, d_model // 64)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        if self.n_kv_heads == self.n_heads:
            n_kv = n_heads
        kw = dict(
            n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv, head_dim=hd, d_ff=2 * d_model,
            vocab_size=vocab,
        )
        if self.n_experts:
            kw.update(n_experts=min(self.n_experts, n_experts),
                      experts_per_token=min(self.experts_per_token, 2),
                      n_shared_experts=min(self.n_shared_experts, 1),
                      moe_d_ff=d_model // 2 if self.moe_d_ff else 0)
        if self.cross_attn_every:
            kw.update(cross_attn_every=min(self.cross_attn_every, n_layers),
                      n_context_tokens=16)
        if self.attn_every:
            kw.update(attn_every=2)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=32)
        return replace(self, **kw)
