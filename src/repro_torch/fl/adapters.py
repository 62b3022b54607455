"""Model adapters — the pluggable-workload boundary of the BHFL runtime.

Port of ``repro.fl.adapters`` with the paper's MNIST MLP
(:class:`MLPAdapter`) only; the LM families are not ported yet (ROADMAP
Queue 1 item 11). ``BHFLRuntime`` needs init / local-train / eval /
flatten / unflatten from an adapter, and flatten/unflatten must use the
canonical sorted-keypath layout of ``core.serialization``, the order HCDS
commits to and ME aggregates in.

:func:`params_from_jax` loads the reference's MLP parameters into the
port, so both packages can start from one init (``jax.random`` draws
cannot be reproduced in torch).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.serialization import flatten_pytree, unflatten_pytree
from repro_torch.fl.client import Client, local_train
from repro_torch.models.mlp import (MLPConfig, mlp_accuracy, mlp_init,
                                    mlp_loss)


class EvalResult(NamedTuple):
    accuracy: float
    loss: float


@dataclass
class MLPAdapter:
    """The paper's 784-hidden-10 MLP over ``SyntheticImageDataset`` shards,
    trained with SGD+momentum+decay exactly as §7.1 specifies, on
    ``device`` (the CUDA card unless the caller asks for the CPU)."""

    cfg: MLPConfig = MLPConfig()
    local_epochs: int = 1
    batch_size: int = 32
    lr: float = 1e-3
    momentum: float = 0.9
    decay: float = 5e-4
    device: Optional[torch.device | str] = None   # None: the CUDA card

    name: str = "mlp"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def init(self, generator: torch.Generator) -> dict:
        return mlp_init(self.cfg, generator, device=self.device)

    def local_train(self, params: dict, client: Client, *,
                    seed: int = 0) -> tuple[dict, float]:
        return local_train(params, client, self.cfg,
                           epochs=self.local_epochs,
                           batch_size=self.batch_size, lr=self.lr,
                           momentum=self.momentum, decay=self.decay,
                           seed=seed)

    @torch.no_grad()
    def evaluate(self, params: dict, dataset: Any) -> EvalResult:
        x = torch.as_tensor(dataset.x, device=self.device)
        y = torch.as_tensor(dataset.y, device=self.device)
        return EvalResult(
            float(mlp_accuracy(params, x, y, cfg=self.cfg)),
            float(mlp_loss(params, x, y, cfg=self.cfg)))

    def flatten(self, params: dict) -> torch.Tensor:
        return flatten_pytree(params)

    def unflatten(self, flat: Any, template: dict) -> dict:
        return unflatten_pytree(flat, template)


def params_from_jax(params: Mapping[str, Any], cfg: MLPConfig = MLPConfig(),
                    device: torch.device | str | None = None) -> dict:
    """The reference's MLP parameters (a dict of numpy arrays, e.g.
    ``{k: np.asarray(v) for k, v in repro_params.items()}``) as the port's
    float32 tensors on ``device`` (the card unless the caller asks for
    the CPU). Names, shapes and dtypes are checked against ``cfg``; values
    are copied bit for bit."""
    dev = resolve_device(device)
    want = {"w1": (cfg.in_dim, cfg.hidden), "b1": (cfg.hidden,),
            "w2": (cfg.hidden, cfg.n_classes), "b2": (cfg.n_classes,)}
    if set(params) != set(want):
        raise ValueError(f"MLP parameters must be named {sorted(want)}; "
                         f"got {sorted(params)}")
    out = {}
    for k, shape in want.items():
        arr = np.asarray(params[k])
        if arr.shape != shape:
            raise ValueError(f"{k} has shape {arr.shape}; {cfg} needs "
                             f"{shape}")
        if arr.dtype != np.float32:
            raise TypeError(f"{k} has dtype {arr.dtype}; the MLP is float32")
        out[k] = torch.from_numpy(arr.copy()).to(dev)
    return out

