"""The PoFEL round in plain PyTorch and NumPy: per-cluster FedSGD, Eq. 1,
Eq. 2, the votes and the BTSV tally (Alg. 4), and the outer update
(sgd1: the aggregate is the next global model).

The parameters are held in the dtype each leaf is configured in
(bfloat16 matrices, float32 norms), and every update is computed in
float32 and rounded to that dtype, as a deployment stores them. Eq. 2's
sums are in float64.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from perfbench.harness.weights import flatten, nest
from perfbench.reference.precision import Products

F32 = torch.float32


class RoundOut(NamedTuple):
    losses: np.ndarray        # (C,)
    sims: np.ndarray          # (C,) Eq. 2, float64
    grad_norms: Dict[str, float]   # per leaf, the largest ‖g_c‖ over c


def layer_slices(path: str, t: torch.Tensor) -> list:
    """A stacked leaf's layers one at a time; any other leaf whole."""
    return list(range(t.shape[0])) if path.startswith("layers/") \
        else [slice(None)]


def _eq2(replicas: List[dict], gw: dict) -> np.ndarray:
    """cos(w_c, gw) over all leaves, each sum in float64 a layer slice
    at a time."""
    C = len(replicas)
    dot, wsq, gsq = np.zeros(C), np.zeros(C), 0.0
    for path, g in gw.items():
        for i in layer_slices(path, g):
            gi = g[i].double()
            gsq += float(torch.sum(gi * gi))
            for c in range(C):
                wi = replicas[c][path][i].double()
                dot[c] += float(torch.sum(wi * gi))
                wsq[c] += float(torch.sum(wi * wi))
    return np.clip(dot / np.maximum(np.sqrt(wsq) * np.sqrt(gsq), 1e-12),
                   -1.0, 1.0)


def fedsgd_round(params: Optional[dict], batches: List[dict],
                 loss_and_grads: Callable, arch: dict, lr: float,
                 prod: Products, start: Optional[dict] = None) -> tuple:
    """One round: each cluster's SGD step on its batch (the model's
    ``loss_and_grads``), from the global ``params`` (nested tree) or,
    where ``start`` (a flat tree of (C, ...) leaves) is given, from its
    own replica; Eq. 1 with λ all ones; Eq. 2. Returns (the next global
    tree, :class:`RoundOut`)."""
    replicas, losses = [], []
    gnorm: Dict[str, float] = {}
    for c, b in enumerate(batches):
        own = flatten(params) if start is None else \
            {p: t[c] for p, t in start.items()}
        loss, grads = loss_and_grads(nest(own), b, arch, prod)
        losses.append(float(loss))
        g = flatten(grads)
        del grads
        rep = {}
        for path, w in own.items():
            gp = g.pop(path)
            gnorm[path] = max(gnorm.get(path, 0.0), float(
                torch.linalg.vector_norm(gp, dtype=torch.float64)))
            rep[path] = (w.to(F32) - lr * gp).to(w.dtype)
            del gp
        replicas.append(rep)
    C = len(replicas)
    gw = {}
    for path, w in replicas[0].items():
        acc = torch.zeros(w.shape, dtype=F32, device=w.device)
        for rep in replicas:
            acc += rep[path].to(F32)
        gw[path] = (acc / C).to(w.dtype)
        del acc
    sims = _eq2(replicas, gw)
    del replicas
    return nest(gw), RoundOut(np.array(losses), sims, gnorm)


def btsv_tally(votes: np.ndarray, history: np.ndarray, pofel: dict
               ) -> dict:
    """Alg. 4 in float64 for N voters who vote ``votes`` (N,), with the
    trainer's prediction rows (g_max on the vote, the rest shared): Eq.
    3-10 and the rolling history. Returns scores, weights, advotes,
    leader and the new history."""
    b = pofel["btsv"]
    N = len(votes)
    A = (votes[:, None] == np.arange(N)[None, :]).astype(np.float64)
    g_min = (1.0 - pofel["g_max"]) / (N - 1)
    P = np.full((N, N), g_min)
    P[np.arange(N), votes] = pofel["g_max"]
    x_bar = A.mean(axis=0)
    log_p = np.log(np.maximum(P, b["eps"]))
    y_bar = np.exp(log_p.mean(axis=0))
    log_x = np.log(np.maximum(x_bar, b["eps"]))
    info = A @ (log_x - np.log(np.maximum(y_bar, b["eps"])))
    pred = b["alpha"] * np.sum(np.where(x_bar > 0, x_bar * (log_p - log_x),
                                        0.0), axis=1)
    scores = info + pred
    chs = history.sum(axis=0) + scores
    wv = b["beta"] / (1.0 + np.exp(-b["theta"] * chs - b["epsilon"]))
    advotes = wv @ A
    return {"scores": scores, "weights": wv, "advotes": advotes,
            "leader": int(np.argmax(advotes)),
            "history": np.concatenate([history[1:], scores[None]], axis=0)}


def leaf_change_norms(a: dict, b: dict) -> Dict[str, float]:
    """‖a − b‖ of each leaf of two flat trees, the differences and their
    squares summed in float64 a layer slice at a time."""
    out = {}
    for path, x in a.items():
        y = b[path]
        sq = 0.0
        for i in layer_slices(path, x):
            d = x[i].double() - y[i].double()
            sq += float(torch.sum(d * d))
        out[path] = sq ** 0.5
    return out
