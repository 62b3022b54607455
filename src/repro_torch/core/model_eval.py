"""ME — Model Evaluation (paper §4.2, Alg. 3), in PyTorch.

Port of ``repro.core.model_eval``. Given the N FEL models W(k) and the
per-cluster dataset sizes |DS_m|:

  gw(k) = Σ_m |DS_m| w^m(k) / |DS|                      (Eq. 1)
  s_m   = <w^m, gw> / (‖w^m‖ ‖gw‖)                      (Eq. 2)
  vote  = argmax_m s_m
  P^i   : G_max for the voted node, G_min for the rest   (Alg. 3 lines 6-12)

:func:`model_evaluation` computes Eq. 1 with the weighted-aggregate kernel
and Eq. 2 with the cosine-partials kernel, both from
``repro_torch.kernels``: on a CUDA tensor those are the hand-written
Hopper kernels (fixed-order, atomic-free reductions, so every honest node
gets bit-identical (gw, sims)), on a CPU tensor their plain versions. The
plain :func:`aggregate_global` / :func:`cosine_similarities` stay as the
reference's jnp-path counterparts.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.core.serialization import flatten_pytree
from repro_torch.kernels.ops import (combine_partials, cosine_partials,
                                     weighted_aggregate)
from repro_torch.kernels.ref import (cosine_similarity_ref,
                                     weighted_aggregate_ref)


class MEResult(NamedTuple):
    global_model: torch.Tensor    # (D,) — gw(k)
    similarities: torch.Tensor    # (N,) — s_m
    vote: torch.Tensor            # ()  int64 — e_best
    predictions: torch.Tensor     # (N,) — P^i


def aggregate_global(W: torch.Tensor, data_sizes: torch.Tensor) -> torch.Tensor:
    """Eq. 1 — data-size-weighted aggregation of (N, D) stacked models, in
    plain PyTorch (the weighted-aggregate kernel's plain version)."""
    return weighted_aggregate_ref(W, data_sizes)


def cosine_similarities(W: torch.Tensor, gw: torch.Tensor,
                        eps: float = 1e-12) -> torch.Tensor:
    """Eq. 2 — cosine similarity of every row of W against gw, in plain
    PyTorch."""
    return cosine_similarity_ref(W, gw, eps)


def make_predictions(vote: Any, n: int, g_max: float = 0.99,
                     device: Any = None) -> torch.Tensor:
    """Alg. 3 lines 6-12 — G_max on the voted index, G_min elsewhere.

    G_min = (1 - G_max)/(N - 1) so that Σ_j p_j = 1 (paper §7.4); a
    single-node network has no "rest", so the row is one-hot.
    """
    if n == 1:
        return torch.ones((1,), device=device)
    g_min = (1.0 - g_max) / (n - 1)
    preds = torch.full((n,), g_min, dtype=torch.float32, device=device)
    preds[vote] = g_max
    return preds


def model_evaluation(W: torch.Tensor, data_sizes: torch.Tensor,
                     g_max: float = 0.99) -> MEResult:
    """Full ME (Alg. 3) over stacked (N, D) models, on W's device."""
    W = W.to(torch.float32).contiguous()
    gw = weighted_aggregate(W, data_sizes.to(W.device))
    sims = combine_partials(*cosine_partials(W, gw))
    vote = torch.argmax(sims)
    preds = make_predictions(vote, W.shape[0], g_max=g_max, device=W.device)
    return MEResult(gw, sims, vote, preds)


def model_evaluation_pytrees(models: Sequence[Any],
                             data_sizes: Sequence[float],
                             g_max: float = 0.99) -> MEResult:
    """ME over a list of parameter trees (paper-faithful runtime path),
    on the models' device."""
    W = torch.stack([flatten_pytree(m) for m in models])
    sizes = torch.tensor([float(s) for s in data_sizes], dtype=torch.float32,
                         device=W.device)
    return model_evaluation(W, sizes, g_max=g_max)


# ---------------------------------------------------------------------------
# Decomposed similarity for the sharded consensus (beyond-paper optimization)
# ---------------------------------------------------------------------------

class PartialTerms(NamedTuple):
    dot: torch.Tensor      # <w_shard, gw_shard>
    w_sq: torch.Tensor     # ‖w_shard‖²
    gw_sq: torch.Tensor    # ‖gw_shard‖²


def partial_terms(w_shard: torch.Tensor,
                  gw_shard: torch.Tensor) -> PartialTerms:
    """Per-shard partial reductions; sum across shards then combine."""
    w = w_shard.to(torch.float32).reshape(-1)
    g = gw_shard.to(torch.float32).reshape(-1)
    return PartialTerms(torch.dot(w, g), torch.dot(w, w), torch.dot(g, g))


def similarity_from_partials(t: PartialTerms,
                             eps: float = 1e-12) -> torch.Tensor:
    """Combine (already summed-across-shards) partials into s_m."""
    return combine_partials(t.dot, t.w_sq, t.gw_sq, eps)
