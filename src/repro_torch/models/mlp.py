"""The paper's MLP (§7.1): flatten → hidden(128, ReLU) → dropout(0.2)
→ output(10, softmax), as a dict of tensors and a plain ``mlp_apply``.

Port of ``repro.models.mlp``. The parameter dict has the reference's
names, shapes and layout (``w1`` is (in, hidden), ``x @ w1``), so its
canonical serialization matches the reference's byte for byte.

``jax.random`` draws cannot be reproduced in torch: :func:`mlp_init`
draws from a ``torch.Generator`` (on the CPU, so the same seed gives the
same init on every device), and dropout draws its mask from a generator
seeded per SGD step (:func:`step_generator`). The batched FEL engine
draws the same masks beforehand, outside ``torch.func.vmap``, and passes
them in (``mask=``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device


class MLPConfig(NamedTuple):
    in_dim: int = 784
    hidden: int = 128     # "128 neurons by default"; swept in Figs 4-6
    n_classes: int = 10
    dropout: float = 0.2


def mlp_init(cfg: MLPConfig, generator: torch.Generator,
             device: Optional[torch.device | str] = None) -> dict:
    """He-normal weights and zero biases, drawn on the CPU from
    ``generator`` and moved to ``device`` (the CUDA card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    s1 = math.sqrt(2.0 / cfg.in_dim)
    s2 = math.sqrt(2.0 / cfg.hidden)
    params = {
        "w1": torch.randn((cfg.in_dim, cfg.hidden), generator=generator) * s1,
        "b1": torch.zeros((cfg.hidden,)),
        "w2": torch.randn((cfg.hidden, cfg.n_classes),
                          generator=generator) * s2,
        "b2": torch.zeros((cfg.n_classes,)),
    }
    return {k: v.to(device) for k, v in params.items()}


def step_generator(seed: int, step: int,
                   device: torch.device | str) -> torch.Generator:
    """The dropout generator of one SGD step: a fresh generator on
    ``device`` seeded from (seed, step) alone, so a step's mask never
    depends on how many draws came before it."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]) >> 1)


def dropout_mask(generator: torch.Generator, keep: float, shape: tuple,
                 device: torch.device | str) -> torch.Tensor:
    """Bernoulli(keep) boolean mask of ``shape``."""
    return torch.rand(shape, generator=generator, device=device) < keep


def mlp_apply(params: dict, x: torch.Tensor, *, cfg: MLPConfig,
              train: bool = False,
              generator: Optional[torch.Generator] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits. Training with dropout draws its keep-mask from
    ``generator``, or takes a boolean ``mask`` of the hidden layer's
    shape drawn beforehand (no draw happens here, as ``torch.func.vmap``
    requires)."""
    h = torch.relu(x @ params["w1"] + params["b1"])
    if train and cfg.dropout > 0.0:
        keep = 1.0 - cfg.dropout
        if mask is None:
            if generator is None:
                raise ValueError("training with dropout needs a generator "
                                 "or a mask")
            mask = dropout_mask(generator, keep, tuple(h.shape), h.device)
        h = torch.where(mask, h / keep, torch.zeros((), device=h.device))
    return h @ params["w2"] + params["b2"]  # logits; softmax folded into loss


def mlp_per_example_loss(params: dict, x: torch.Tensor, y: torch.Tensor, *,
                         cfg: MLPConfig, train: bool = False,
                         generator: Optional[torch.Generator] = None,
                         mask: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """(B,) per-sample cross-entropies; ``generator`` and ``mask`` as in
    :func:`mlp_apply`."""
    logits = mlp_apply(params, x, cfg=cfg, train=train, generator=generator,
                       mask=mask)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, y.to(torch.int64)[:, None])[:, 0]


def mlp_loss(params: dict, x: torch.Tensor, y: torch.Tensor, *,
             cfg: MLPConfig, train: bool = False,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return torch.mean(mlp_per_example_loss(params, x, y, cfg=cfg, train=train,
                                           generator=generator))


def mlp_accuracy(params: dict, x: torch.Tensor, y: torch.Tensor, *,
                 cfg: MLPConfig) -> torch.Tensor:
    logits = mlp_apply(params, x, cfg=cfg, train=False)
    return torch.mean((torch.argmax(logits, dim=-1) == y).to(torch.float32))
