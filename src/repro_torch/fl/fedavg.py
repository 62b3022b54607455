"""FedAvg aggregation (McMahan et al. 2017) — the edge-level aggregation
the paper uses inside each FEL cluster (§3.1 footnote 2).

Port of ``repro.fl.fedavg`` over dicts of tensors."""

from __future__ import annotations

from typing import Sequence

import torch


def fedavg(models: Sequence[dict], weights: Sequence[float]) -> dict:
    """Data-size-weighted average of parameter dicts, on their device."""
    first = models[0]
    device = next(iter(first.values())).device
    w = torch.tensor([float(x) for x in weights], dtype=torch.float32,
                     device=device)
    w = w / torch.sum(w)
    out = {}
    for k, leaf in first.items():
        stacked = torch.stack([m[k].to(torch.float32) for m in models])
        out[k] = torch.einsum("n,n...->...", w, stacked).to(leaf.dtype)
    return out
