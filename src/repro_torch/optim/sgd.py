"""SGD with momentum and lr decay — the paper's optimizer (§7.1:
"SGD optimizer ... learning rate 0.001, decay factor equal to half of the
learning rate, momentum 0.9").

Port of ``repro.optim.sgd``, written by hand because ``torch.optim.SGD``
has no Keras-style time decay. It updates in place: the caller owns
``params`` and the state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SGDState:
    momentum: dict      # like params
    step: int = 0


def sgd_init(params: dict) -> SGDState:
    return SGDState({k: torch.zeros_like(v) for k, v in params.items()})


@torch.no_grad()
def sgd_update(grads: dict, state: SGDState, params: dict,
               lr: float = 1e-3, momentum: float = 0.9,
               decay: float = 5e-4) -> None:
    """Keras-style time-based decay: lr_t = lr / (1 + decay * t);
    m ← μ·m + g; p ← p − lr_t·m. ``params`` and ``state`` are updated in
    place. lr_t is computed in float32, as the reference does.

    Types follow the reference's jnp promotion: μ is taken in m's dtype
    (a weak Python scalar there), and lr_t is a float32 array, so a
    bfloat16 leaf's update is float32: its entry in ``params`` is replaced
    by the float32 result (and a bfloat16 momentum by a float32 one once
    the gradient is float32). float32 leaves are updated in place."""
    lr_t = np.float32(lr) / (np.float32(1.0)
                             + np.float32(decay) * np.float32(state.step))
    for k, p in params.items():
        m, g = state.momentum[k], grads[k]
        mu = momentum if m.dtype == torch.float32 else float(
            torch.tensor(momentum, dtype=m.dtype))
        if m.dtype == g.dtype:
            m.mul_(mu).add_(g)
        else:
            m = state.momentum[k] = m * mu + g
        if p.dtype == m.dtype == torch.float32:
            p.sub_(float(lr_t) * m)
        else:
            params[k] = (p.to(torch.float32)
                         - float(lr_t) * m.to(torch.float32))
    state.step += 1
