"""FedAvg aggregation (McMahan et al. 2017) — the edge-level aggregation
the paper uses inside each FEL cluster (§3.1 footnote 2).

Port of ``repro.fl.fedavg`` over dicts of tensors."""

from __future__ import annotations

from typing import Sequence

import torch


def fedavg(models: Sequence[dict], weights: Sequence[float]) -> dict:
    """Data-size-weighted average of parameter dicts (nested dicts
    allowed), on their device; each leaf keeps the first model's dtype."""
    first = models[0]
    device = next(iter(_leaves(first))).device
    w = torch.tensor([float(x) for x in weights], dtype=torch.float32,
                     device=device)
    w = w / torch.sum(w)

    def avg(trees: Sequence[dict]) -> dict:
        out = {}
        for k, leaf in trees[0].items():
            if isinstance(leaf, dict):
                out[k] = avg([t[k] for t in trees])
                continue
            stacked = torch.stack([t[k].to(torch.float32) for t in trees])
            out[k] = torch.einsum("n,n...->...", w, stacked).to(leaf.dtype)
        return out

    return avg(models)


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
