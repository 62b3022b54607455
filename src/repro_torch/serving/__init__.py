"""Serving: the batched generation engine and its samplers (port of
``repro.serving``)."""

from repro_torch.serving.engine import (Completion, GenerationRequest,
                                        ServingEngine, grow_cache,
                                        serve_batch)
from repro_torch.serving.sampler import SamplerConfig, sample_token

__all__ = ["Completion", "GenerationRequest", "ServingEngine", "SamplerConfig",
           "grow_cache", "sample_token", "serve_batch"]
