"""Architecture registry of the port (counterpart of ``repro.configs``).

The ids are the reference's. A config is registered here when its family
is ported; :func:`get_config` on any other id raises and names the
ROADMAP item that brings its family over.
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
}

# why a family is not ported yet: the ROADMAP item that brings it. Read by
# get_config and by models.model_api.Model.
_CROSS = ("ROADMAP Queue 1 item 11c: the cross-attention (vision/audio) "
          "families")
NOT_PORTED = {
    "vlm": _CROSS,
    "audio": _CROSS,
    "mlp": "the paper's MLP is repro_torch.models.mlp.MLPConfig, run by "
           "repro_torch.api.run_bhfl",
}
_FAMILY_OF = {          # the ids whose family is not ported
    "llama-3.2-vision-90b": "vlm",
    "musicgen-medium": "audio",
    "mnist-mlp": "mlp",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in _FAMILY_OF:
        raise NotImplementedError(
            f"{arch_id!r} is not ported to repro_torch yet: "
            f"{NOT_PORTED[_FAMILY_OF[arch_id]]}")
    if arch_id not in _PORTED:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_PORTED[arch_id]}")
    return mod.CONFIG


__all__ = ["ARCH_IDS", "NOT_PORTED", "get_config"]
