"""Token samplers for the serving engine: greedy / temperature / top-k /
top-p (nucleus). Port of ``repro.serving.sampler``; draws come from a
``torch.Generator`` instead of a ``jax.random`` key."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplerConfig(NamedTuple):
    temperature: float = 0.0      # 0 → greedy
    top_k: int = 0                # 0 → disabled
    top_p: float = 1.0            # 1 → disabled


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 cfg: SamplerConfig) -> torch.Tensor:
    """(B, V) logits → (B,) int32 tokens. ``generator`` lives on the
    logits' device; greedy decoding draws nothing and may pass None."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / cfg.temperature
    neg_inf = torch.tensor(-torch.inf, device=logits.device)

    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -cfg.top_k][:, None]
        logits = torch.where(logits < kth, neg_inf, logits)

    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set whose mass ≥ top_p (always keep the argmax)
        cutoff_idx = torch.sum(cum < cfg.top_p, dim=-1).clamp(
            max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, neg_inf, logits)

    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
