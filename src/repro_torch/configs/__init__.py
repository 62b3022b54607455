"""Architecture registry of the port (counterpart of ``repro.configs``).

The ids are the reference's, and every one of them is registered.
``mnist-mlp`` is there for completeness, as in the reference: the FL
runtime runs the paper's MLP from ``repro_torch.models.mlp`` and
``models.model_api.Model`` refuses its family (:data:`NOT_PORTED`).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "phi3.5-moe-42b-a6.6b",
    "llama-3.2-vision-90b",
    "musicgen-medium",
    "rwkv6-1.6b",
    "deepseek-moe-16b",
    "starcoder2-3b",
    "qwen2.5-14b",
    "yi-6b",
    "mistral-nemo-12b",
    "zamba2-7b",
    "mnist-mlp",        # the paper's own model
]

_PORTED = {                                 # id -> module of its config
    "rwkv6-1.6b": "rwkv6_1_6b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen2.5-14b": "qwen2_5_14b",
    "yi-6b": "yi_6b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "zamba2-7b": "zamba2_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "musicgen-medium": "musicgen_medium",
    "mnist-mlp": "mnist_mlp",
}

# why models.model_api.Model does not run a family: the paper's MLP is its
# own model, run by the API
NOT_PORTED = {
    "mlp": "the paper's MLP is repro_torch.models.mlp.MLPConfig, run by "
           "repro_torch.api.run_bhfl",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _PORTED:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_PORTED[arch_id]}")
    return mod.CONFIG


__all__ = ["ARCH_IDS", "NOT_PORTED", "get_config"]
