"""The weights of a cell, made on the device from the seed.

The layout (names, stacked shapes, dtypes) is the benchmark's own,
worked out from the configuration's file by its family's plain
reference, and is checked against what
the program declares (``Model.param_shapes()``) before a run. The values
follow a copy of the port's init rule (``repro_torch.models.layers``
``dense_init``/``embed_init``): matrices
a standard normal truncated to [-2, 2] over √d_in, the embedding the
same times 0.02, norms ones. Each stacked leaf is one draw of its whole
shape from a ``torch.Generator`` on the device, so the same seed gives
the same weights, and set-up makes them in a few large calls.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, Tuple

import torch

BF16, F32 = torch.bfloat16, torch.float32

# Φ(-2) and Φ(2): the standard normal's CDF at the truncation bounds
_CDF_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_CDF_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))

# path -> (shape, dtype, init rule)
Layout = Dict[str, Tuple[tuple, torch.dtype, str]]


def model_reference(arch: dict):
    """The plain reference of the configuration's model family: the
    module ``perfbench/reference/<arch["reference"]>.py``, with its
    ``layout(arch)``, ``loss_and_grads`` and ``forward_flops``."""
    return importlib.import_module(
        f"perfbench.reference.{arch['reference']}")


def layout(arch: dict) -> Layout:
    return model_reference(arch).layout(arch)


def truncated_normal(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=F32)
    x = torch.erfinv(2.0 * (_CDF_LO + (_CDF_HI - _CDF_LO) * u) - 1.0)
    return torch.clamp(x * math.sqrt(2.0), -2.0, 2.0)


def _draw(gen: torch.Generator, shape: tuple, dtype, rule: str
          ) -> torch.Tensor:
    dev = gen.device
    if rule == "dense":
        scale = 1.0 / math.sqrt(shape[-2])
        return (truncated_normal(gen, shape) * scale).to(dtype)
    if rule == "embed":
        return (truncated_normal(gen, shape) * 0.02).to(dtype)
    if rule == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    raise ValueError(f"no init rule {rule!r}")


def nest(flat: dict) -> dict:
    """{"a/b": t} → {"a": {"b": t}}."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def make_weights(arch: dict, seed: int, device) -> dict:
    """The nested weight tree of ``arch`` drawn from ``seed`` on
    ``device``; leaves in sorted path order, one draw each."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    lay = layout(arch)
    return nest({p: _draw(gen, *lay[p]) for p in sorted(lay)})


def check_layout(arch: dict, declared: dict) -> None:
    """Raise unless the program's ``param_shapes()`` tree declares the
    benchmark's layout: the same paths, shapes and dtypes."""
    mine = {p: (tuple(s), d) for p, (s, d, _) in layout(arch).items()}
    theirs = {p: (tuple(s), d) for p, (s, d) in flatten(
        declared).items()}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()),
                      key=lambda kv: kv[0])
        raise ValueError(f"the program's parameter layout differs from the "
                         f"benchmark's: {diff[:6]}")


def replica_seed(seed: int) -> int:
    """The device generator's seed for the replicas' spread, apart from
    the weights' (``seed``) and the contexts' streams."""
    return 4 * seed + 2


def diverged(params: dict, seed: int, clusters: int, spread: float
             ) -> dict:
    """The clusters' replicas as they enter the first checked round,
    apart as after local iterations of their own: cluster c's leaf is
    the global leaf plus ``spread`` · (c + 1) · the leaf's RMS times a
    standard normal, in float32, rounded to the leaf's dtype. A flat
    tree of (C, ...) leaves, drawn from ``seed`` on the weights' device
    a leaf at a time, in sorted path order."""
    flat = flatten(params)
    dev = next(iter(flat.values())).device
    gen = torch.Generator(device=dev).manual_seed(replica_seed(seed))
    steps = spread * torch.arange(1, clusters + 1, dtype=F32, device=dev)
    out = {}
    for p in sorted(flat):
        w = flat[p].to(F32)
        z = torch.randn((clusters,) + tuple(w.shape), generator=gen,
                        device=dev, dtype=F32)
        z *= (steps * torch.sqrt(torch.mean(w * w))).view(
            (clusters,) + (1,) * w.dim())
        z += w
        out[p] = z.to(flat[p].dtype)
        del z, w
    return out


def mean_replica(replicas: dict) -> dict:
    """The mean of the clusters' replicas a leaf, summed in float32 and
    rounded to the leaf's dtype: where both sides' weight changes are
    measured from when the replicas start apart."""
    out = {}
    for p, t in replicas.items():
        acc = torch.zeros(t.shape[1:], dtype=F32, device=t.device)
        for row in t:
            acc += row.to(F32)
        out[p] = (acc / t.shape[0]).to(t.dtype)
        del acc
    return out
