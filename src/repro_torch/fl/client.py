"""FL client: local SGD training over the client's own data shard
(paper §3.1 step 3).

Port of ``repro.fl.client``. The gradient is autograd over the MLP's
``torch.matmul``s, on the device of the parameters; the batch order is
the reference's bit for bit (``np.random.default_rng(seed + ep)``
permutations, drop-remainder windows).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.models.mlp import MLPConfig, mlp_loss, step_generator
from repro_torch.optim.sgd import sgd_init, sgd_update


@dataclass
class Client:
    client_id: int
    data: Any        # SyntheticImageDataset (adapter-defined)

    @property
    def data_size(self) -> int:
        return len(self.data)


def local_train(params: dict, client: Client, cfg: MLPConfig, *,
                epochs: int = 1, batch_size: int = 32, lr: float = 1e-3,
                momentum: float = 0.9, decay: float = 5e-4,
                seed: int = 0) -> tuple[dict, float]:
    """Run ``epochs`` of local SGD from ``params``; returns (new_params,
    last_loss). ``params`` is left untouched.

    Callers must skip empty clients (``BHFLRuntime._run_fel`` does); an
    empty shard raises here. The shard is copied to the parameters'
    device once per call and batches are gathered there. Dropout draws
    its mask from a generator seeded by (seed, step).
    """
    if client.data_size == 0:
        raise ValueError(
            f"client {client.client_id} has an empty shard; callers must "
            "skip empty clients (batch_size must be positive)")
    device = next(iter(params.values())).device
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    opt_state = sgd_init(params)
    xd = torch.as_tensor(client.data.x, device=device)
    yd = torch.as_tensor(client.data.y, device=device)
    n = client.data_size
    bs = min(batch_size, n)
    keys = sorted(params)
    loss = torch.zeros(())
    step = 0
    for ep in range(epochs):
        order = np.random.default_rng(seed + ep).permutation(n)
        for s in range(0, n - bs + 1, bs):
            sel = torch.as_tensor(order[s:s + bs], device=device)
            gen = (step_generator(seed, step, device) if cfg.dropout > 0.0
                   else None)
            loss = mlp_loss(params, xd[sel], yd[sel], cfg=cfg, train=True,
                            generator=gen)
            grads = torch.autograd.grad(loss, [params[k] for k in keys])
            sgd_update(dict(zip(keys, grads)), opt_state, params, lr=lr,
                       momentum=momentum, decay=decay)
            step += 1
    return ({k: v.detach() for k, v in params.items()},
            float(loss.detach()))
