"""AdamW for the LLM-scale training path (port of ``repro.optim.adamw``).

Functional, as the reference: ``adamw_update`` returns new params and a
new state over nested dicts of tensors and leaves the inputs as they
are. It runs leaf by leaf, so beyond the result only one leaf's float32
temporaries are alive at a time.

Types follow the reference's jnp promotion, which torch's differs from
in two ways, both made explicit here:

* a 0-d float32 tensor times a bfloat16 tensor is float32 in JAX and
  bfloat16 in torch. The reference multiplies by three such scalars: the
  clip scale, the bias corrections and ``lr_t``. So with bfloat16 params
  and the default ``grad_clip=1.0`` the clipped gradient, and with it
  ``mu`` and ``nu``, are float32 from the first step; with
  ``grad_clip=None`` the moments stay bfloat16 and only the update is
  float32;
* a Python float is weakly typed in JAX: against a bfloat16 tensor it is
  rounded to bfloat16 first (0.9 becomes 0.8984375), where torch keeps it
  at full precision (:func:`_weak`).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.serialization import leaves_with_paths, map_tree


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor      # () int32


def _promoted(x: torch.Tensor, scalar: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype jnp gives ``x * scalar`` for a 0-d ``scalar``."""
    return x.to(torch.promote_types(x.dtype, scalar.dtype))


def _weak(c: float, x: torch.Tensor) -> float:
    """The Python float ``c`` as jnp takes it against ``x``: rounded to
    ``x``'s dtype."""
    if x.dtype in (torch.float32, torch.float64):
        return c
    return float(torch.tensor(c, dtype=x.dtype))


def adamw_init(params: Any) -> AdamWState:
    (_, leaf), *_ = leaves_with_paths(params)
    return AdamWState(map_tree(torch.zeros_like, params),
                      map_tree(torch.zeros_like, params),
                      torch.zeros((), dtype=torch.int32, device=leaf.device))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any,
                 lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: float | None = 1.0) -> tuple[Any, AdamWState]:
    step = state.step + 1
    lr_t = (lr(step) if callable(lr)
            else torch.tensor(lr, dtype=torch.float32, device=step.device))

    scale = None
    if grad_clip is not None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for _, g in leaves_with_paths(grads)))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)

    t = step.to(torch.float32)
    mu_hat_scale = 1.0 / (1.0 - b1 ** t)
    nu_hat_scale = 1.0 / (1.0 - b2 ** t)

    def leaf(p, m, v, g):
        if scale is not None:
            g = _promoted(g, scale) * scale
        m = _weak(b1, m) * m + _weak(1 - b1, g) * g
        v = _weak(b2, v) * v + _weak(1 - b2, g) * torch.square(g)
        m_hat = _promoted(m, mu_hat_scale) * mu_hat_scale
        v_hat = _promoted(v, nu_hat_scale) * nu_hat_scale
        upd = (m_hat / (torch.sqrt(v_hat) + eps)
               + _weak(weight_decay, p) * p)
        return (p - lr_t * _promoted(upd, lr_t)).to(p.dtype), m, v

    out = map_tree(leaf, params, state.mu, state.nu, grads)
    new_params, mu, nu = (map_tree(lambda o, i=i: o[i], out)
                          for i in range(3))
    return new_params, AdamWState(mu, nu, step)
