"""Batched serving engine over the PoFEL global model.

Port of ``repro.serving.engine``: a static-batch generation loop over
``Model.prefill`` / ``decode_step`` with per-request lengths, EOS
handling and pluggable sampling. A model that needs a context (vlm,
audio) gets the reference's stub, ``0.1 * ones`` float32
(``Model.stub_context``), in its prefill batch.

Requests are left-padded into one batch. A transformer runs the padded
prompts through one ``prefill`` at positions 0..max_p-1 with no padding
mask (the reference attends to the pad tokens too), and its KV cache is
grown by the token budget along the sequence axis. A recurrent model
replays the prompt through decode steps so the O(1) state absorbs it
(the padding contributes a short constant-token prefix, harmless for the
state). Decode step ``i`` runs at position max_p + i. The engine tracks
per-request progress and returns completions when all requests finish or
hit their token budget.

Two spans go to the active ``repro_torch.obs`` recorder:
``serve_prompt`` (prefill or prompt replay up to the first sampled
token, read back to the host) and ``serve_decode`` (the decode loop,
which reads every step's tokens back).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model_api import Model
from repro_torch.obs import get_recorder
from repro_torch.serving.sampler import SamplerConfig, sample_token


@dataclass
class GenerationRequest:
    request_id: int
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_token: Optional[int] = None


@dataclass
class Completion:
    request_id: int
    tokens: List[int]
    finished_by: str                    # 'eos' | 'length'


class ServingEngine:
    """``device=None`` is the CUDA card; the model must live on the
    engine's device."""

    def __init__(self, model: Model, params: Any,
                 sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
                 device: Optional[torch.device | str] = None):
        self.device = resolve_device(device)
        if self.device.type != model.device.type:
            raise ValueError(f"the engine runs on {self.device} but the model "
                             f"on {model.device}")
        self.model = model
        self.params = params
        self.sampler = sampler
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _pad_prompts(self, requests: List[GenerationRequest]) -> tuple:
        max_p = max(len(r.prompt) for r in requests)
        B = len(requests)
        toks = np.zeros((B, max_p), np.int32)
        for i, r in enumerate(requests):
            # left-pad so every prompt ends at position max_p-1
            toks[i, max_p - len(r.prompt):] = r.prompt
        return torch.from_numpy(toks).to(self.device), max_p

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_token(logits[:, -1].to(torch.float32), self.generator,
                            self.sampler)[:, None]

    @torch.inference_mode()
    def generate(self, requests: List[GenerationRequest]) -> List[Completion]:
        if not requests:
            raise ValueError("generate needs at least one request")
        B = len(requests)
        toks, max_p = self._pad_prompts(requests)
        budget = max(r.max_new_tokens for r in requests)
        rec = get_recorder()

        out_tokens: List[List[int]] = [[] for _ in requests]
        finished = np.zeros((B,), bool)
        finished_by = ["length"] * B

        with rec.span("serve_prompt", batch=B, prompt_len=max_p):
            cfg = self.model.cfg
            if cfg.rwkv or cfg.family == "hybrid":
                cache = self.model.init_cache(B, max_p + budget)
                logits = None
                for i in range(max_p):
                    logits, cache = self.model.decode_step(
                        self.params, cache, toks[:, i:i + 1], i)
            else:
                batch = {"tokens": toks}
                if self.model.needs_context():
                    batch["context"] = self.model.stub_context(B)
                logits, cache = self.model.prefill(self.params, batch)
                cache = grow_cache(cache, budget)
            tok = self._sample(logits)
            for i, t in enumerate(tok[:, 0].tolist()):
                out_tokens[i].append(t)

        with rec.span("serve_decode", batch=B, budget=budget):
            for step in range(budget - 1):
                logits, cache = self.model.decode_step(
                    self.params, cache, tok, max_p + step)
                tok = self._sample(logits)
                t_host = tok[:, 0].tolist()
                for i, r in enumerate(requests):
                    if finished[i]:
                        continue
                    if len(out_tokens[i]) >= r.max_new_tokens:
                        finished[i] = True
                        continue
                    out_tokens[i].append(t_host[i])
                    if r.eos_token is not None and t_host[i] == r.eos_token:
                        finished[i] = True
                        finished_by[i] = "eos"
                if finished.all():
                    break

        return [Completion(r.request_id, out_tokens[i], finished_by[i])
                for i, r in enumerate(requests)]


def grow_cache(cache: Any, budget: int) -> Any:
    """A transformer's prompt-sized KV cache with ``budget`` zero slots
    added along the sequence axis: axis 2 of ``k`` and ``v``, each
    (L, B, S, Hk, hd). The context K/V (vlm, audio) have Nc slots and are
    left as they are.

    The reference's ``_grow_cache`` pads the first axis whose size equals
    the prompt length; when the layer count, the batch size or Nc equals
    it, that is the wrong axis (and the reference raises, or pads the
    context). The axis is named here, so those batches serve."""
    def grow(t):
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, budget))

    return cache._replace(k=grow(cache.k), v=grow(cache.v))


def serve_batch(model: Model, params: Any, prompts: List[List[int]],
                max_new_tokens: int = 16,
                sampler: SamplerConfig = SamplerConfig(),
                device: Optional[torch.device | str] = None
                ) -> List[List[int]]:
    """One-shot convenience wrapper."""
    engine = ServingEngine(model, params, sampler, device=device)
    reqs = [GenerationRequest(i, np.asarray(p, np.int32), max_new_tokens)
            for i, p in enumerate(prompts)]
    return [c.tokens for c in engine.generate(reqs)]
