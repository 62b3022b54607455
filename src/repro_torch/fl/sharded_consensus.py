"""Sharded Model Evaluation for PoFEL.

Port of ``repro.fl.sharded_consensus``. Cosine similarity (Eq. 2)
reduces over the parameter axis, so a model-parallel deployment never
needs to gather full models to run ME: each shard contributes three
partial sums per node

    (<w_shard, gw_shard>, ||w_shard||^2, ||gw_shard||^2)

which are added across shards and combined
(``core.model_eval.similarity_from_partials``). The aggregation (Eq. 1)
is shard-local too. Per shard the two ME kernels run once each
(``kernels.ops.weighted_aggregate`` for Eq. 1, ``cosine_partials`` for
the partials); the shards' partials are added in shard order, with no
atomics, and the gw shards concatenated.

* :func:`sharded_model_evaluation` — ME over a list of per-shard (N, d_s)
  tensors; numerically the dense ``model_evaluation`` up to the order of
  the partial sums.
* :class:`ShardedModelEvaluation` — a drop-in for the ``model_evaluation``
  phase of ``PoFELConsensus``
  (``consensus.replace_phase("model_evaluation",
  ShardedModelEvaluation(4))``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.core.model_eval import (MEResult, PartialTerms,
                                         make_predictions,
                                         similarity_from_partials)
from repro_torch.core.phases import ConsensusPhase, RoundContext
from repro_torch.core.serialization import flatten_pytree
from repro_torch.kernels.ops import cosine_partials, weighted_aggregate


def shard_flat(W: torch.Tensor, n_shards: int) -> List[torch.Tensor]:
    """Split stacked flat models (N, D) into ``n_shards`` (N, d_s) shards
    along the parameter axis, as ``numpy.array_split`` does (the first
    D mod n_shards shards one column longer)."""
    return list(torch.tensor_split(W, n_shards, dim=1))


def sharded_model_evaluation(shards: Sequence[torch.Tensor],
                             data_sizes: torch.Tensor,
                             g_max: float = 0.99) -> MEResult:
    """ME (Alg. 3) where each shard holds a (N, d_s) slice of W, on the
    shards' device. Only the 3·N partial sums (and the gw shards) leave a
    shard."""
    sizes = torch.as_tensor(data_sizes, dtype=torch.float32,
                            device=shards[0].device)
    n = shards[0].shape[0]
    dot = w_sq = gw_sq = None
    gw_shards = []
    for W_s in shards:
        W_s = W_s.to(torch.float32).contiguous()
        gw_s = weighted_aggregate(W_s, sizes)           # Eq. 1, shard-local
        gw_shards.append(gw_s)
        t = cosine_partials(W_s, gw_s)
        if dot is None:
            dot, w_sq, gw_sq = t
        else:
            dot, w_sq, gw_sq = dot + t[0], w_sq + t[1], gw_sq + t[2]
    sims = similarity_from_partials(PartialTerms(dot, w_sq, gw_sq))
    vote = torch.argmax(sims)
    preds = make_predictions(vote, n, g_max=g_max, device=sims.device)
    return MEResult(torch.cat(gw_shards), sims, vote, preds)


class ShardedModelEvaluation(ConsensusPhase):
    """Phase-API wrapper: flattens the round's models, shards them
    ``n_shards`` ways, and runs the decomposed ME. Drop-in for the dense
    ``ModelEvaluation`` phase of ``PoFELConsensus``."""

    name = "model_evaluation"

    def __init__(self, n_shards: int = 2):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards

    def run(self, ctx: RoundContext) -> None:
        W = torch.stack([flatten_pytree(m) for m in ctx.models])
        shards = shard_flat(W, min(self.n_shards, W.shape[1]))
        ctx.evaluation = sharded_model_evaluation(
            shards, torch.tensor(ctx.data_sizes, dtype=torch.float32),
            g_max=ctx.g_max)
        ctx.extra["me_n_shards"] = len(shards)
