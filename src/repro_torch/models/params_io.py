"""The reference's parameter trees as the port's tensors.

``jax.random`` draws cannot be reproduced in torch, so the parity tests
and any user with reference weights carry a tree over instead: the tree
as numpy arrays (e.g. ``jax.tree.map(np.asarray, repro_params)``) goes
through :func:`tree_from_numpy` with the model's expected
``{name: (shape, dtype)}`` spec. Names, shapes and dtypes are checked;
values are copied bit for bit, bfloat16 leaves included.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def tensor_from_numpy(name: str, arr: Any, shape: tuple,
                      dtype: torch.dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.shape != shape:
        raise ValueError(f"{name} has shape {arr.shape}; the config needs "
                         f"{shape}")
    if dtype == torch.bfloat16:
        # a JAX bfloat16 array reaches numpy with an extension dtype named
        # 'bfloat16' whose dtype string is '<V2': read its raw 2-byte values
        if arr.dtype.name != "bfloat16" or arr.dtype.str != "<V2":
            raise TypeError(f"{name} has dtype {arr.dtype}; the model keeps "
                            f"it in bfloat16")
        raw = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    if arr.dtype != np.float32:
        raise TypeError(f"{name} has dtype {arr.dtype}; the model keeps it "
                        f"in float32")
    return torch.from_numpy(np.array(arr, copy=True))


def tree_from_numpy(params: Mapping[str, Any], spec: Mapping[str, Any],
                    device: torch.device, path: str = "") -> dict:
    """``params`` (nested dicts of arrays) as tensors on ``device``, after
    checking it against ``spec`` (the same nesting, ``(shape, dtype)``
    leaves)."""
    if set(params) != set(spec):
        raise ValueError(f"parameters{' at ' + path if path else ''} must "
                         f"be named {sorted(spec)}; got {sorted(params)}")
    out = {}
    for name, want in spec.items():
        key = f"{path}/{name}" if path else name
        if isinstance(want, Mapping):
            if not isinstance(params[name], Mapping):
                raise ValueError(f"{key} must be a dict of "
                                 f"{sorted(want)}")
            out[name] = tree_from_numpy(params[name], want, device, key)
        else:
            out[name] = tensor_from_numpy(key, params[name], *want).to(device)
    return out
