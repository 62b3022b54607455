"""PoFEL-governed training at LLM scale on one card.

Port of ``repro.fl.pofel_trainer``, the paper's Alg. 1 as one round:

* each of ``n_clusters`` BCFL nodes owns a divergent replica of the model
  (the intermediate FEL model w^c(k)), stored with a leading cluster dim
  (C, ...);
* :func:`local_step` is one FEL iteration: per-cluster FedSGD on the
  cluster's slice of the global batch, every cluster at once under
  ``torch.func.vmap`` of ``torch.func.grad_and_value(Model.loss)``. The
  model kernels' vmap rules fold the clusters into the batch, so each
  attention layer is one flash forward and one flash backward call a
  round (the wkv6 pair likewise);
* :func:`consensus` is Alg. 1 lines 2-5: Eq. 1 and Eq. 2 leaf by leaf on
  the (C, n) view of each stacked leaf, through the port's ME kernels
  (``kernels.ops.weighted_aggregate`` and ``cosine_partials``: one launch
  each a leaf), so the models never move and only 3·C scalars a leaf are
  combined; then the honest votes, the BTSV tally and the leader;
* :func:`pofel_round` adds the outer update (``"sgd1"``: the aggregate is
  the next global model, as the paper has it; ``"nesterov"``: a
  DiLoCo-style step on the pseudo-gradient) and redistributes the new
  global model to every cluster.

The host-side chain (signed blocks of the consensus statistics) is the
launcher's (``repro_torch.launch.train``).

Memory: the redistributed replicas are ``expand`` views of the global
model (no copy, as ``jnp.broadcast_to`` is free under XLA), and the
FedSGD update runs one cluster of one leaf at a time in float32, freeing
each gradient once it is applied. Nothing is updated in place: the state
a round was given is left as it was.

Not ported: ``cluster_axis`` (the cluster dim sharded over a mesh axis)
and ``abstract_train_state`` (the dry run's shapes): one card has no
mesh (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.btsv import BTSVConfig, btsv_round, init_history
from repro_torch.core.serialization import leaves_with_paths, rebuild
from repro_torch.kernels import ops
from repro_torch.models.model_api import Model
from repro_torch.models.params_io import tree_from_numpy
from repro_torch.models.transformer import FwdOptions

CONSENSUS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class PoFELTrainConfig:
    n_clusters: int = 8
    cluster_axis: Optional[str] = None  # a mesh axis: not on one card
    inner_lr: float = 3e-4            # FedSGD step (paper: SGD at clients)
    outer: str = "sgd1"               # 'sgd1' (paper Eq. 1) | 'nesterov'
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    g_max: float = 0.99
    btsv: BTSVConfig = field(default_factory=BTSVConfig)
    aux_weight: float = 0.01
    consensus_dtype: str = "float32"   # Eq. 1 accumulation dtype


class PoFELTrainState(NamedTuple):
    cluster_params: Any        # (C, ...) divergent replicas — W(k)
    global_params: Any         # w_global — last agreed global model
    outer_momentum: Any        # float32 tree like global_params
    btsv_history: torch.Tensor  # (c_window, C) rolling BTS scores
    round: torch.Tensor         # () int32


class ConsensusMetrics(NamedTuple):
    loss: torch.Tensor          # (C,) per-cluster losses
    similarities: torch.Tensor  # (C,) Eq. 2
    leader: torch.Tensor        # () int32 — e*(k)
    vote_weights: torch.Tensor  # (C,) WV^i(k)
    scores: torch.Tensor        # (C,) BTS scores


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    """The tensors of a tree in the reference's flatten order (dict keys
    sorted at each level)."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def _broadcast_clusters(params: Any, C: int) -> Any:
    return _map(lambda t: t[None].expand(C, *t.shape), params)


def init_train_state(model: Model, cfg: PoFELTrainConfig,
                     generator: torch.Generator) -> PoFELTrainState:
    params = model.init(generator)
    dev = model.device
    return PoFELTrainState(
        cluster_params=_broadcast_clusters(params, cfg.n_clusters),
        global_params=params,
        outer_momentum=_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                                  device=dev), params),
        btsv_history=init_history(cfg.n_clusters, cfg.btsv).to(dev),
        round=torch.zeros((), dtype=torch.int32, device=dev),
    )


def train_state_from_jax(state: Any, model: Model,
                         device: torch.device | str | None = None
                         ) -> PoFELTrainState:
    """The reference's ``PoFELTrainState`` with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, state)``) as the port's, on ``device``
    (the model's unless given). Names, shapes and dtypes are checked
    against the model's parameter tree; values are copied bit for bit."""
    dev = model.device if device is None else torch.device(device)
    spec = model.param_shapes()
    C = np.asarray(state.btsv_history).shape[1]
    stacked = _map(lambda s: ((C,) + tuple(s[0]), s[1]), spec)
    f32 = _map(lambda s: (tuple(s[0]), torch.float32), spec)
    return PoFELTrainState(
        cluster_params=tree_from_numpy(state.cluster_params, stacked, dev),
        global_params=tree_from_numpy(state.global_params, spec, dev),
        outer_momentum=tree_from_numpy(state.outer_momentum, f32, dev),
        btsv_history=torch.from_numpy(
            np.array(state.btsv_history, np.float32)).to(dev),
        round=torch.tensor(int(np.asarray(state.round)), dtype=torch.int32,
                           device=dev),
    )


# ---------------------------------------------------------------------------
# Local FEL iteration (per-cluster FedSGD)
# ---------------------------------------------------------------------------

def _sgd(p: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """(p - lr g) in float32, cast back to p's dtype, one cluster at a
    time (the float32 temporaries of one cluster's leaf at most)."""
    out = torch.empty(p.shape, dtype=p.dtype, device=p.device)
    for c in range(p.shape[0]):
        out[c] = (p[c].to(torch.float32)
                  - lr * g[c].to(torch.float32)).to(p.dtype)
    return out


def local_step(model: Model, cluster_params: Any, batch: dict,
               cfg: PoFELTrainConfig, opts: Optional[FwdOptions] = None
               ) -> tuple[Any, torch.Tensor]:
    """One FedSGD step per cluster. batch leaves lead with (C, B/C, ...).
    Returns (new replicas, losses (C,))."""
    if cfg.cluster_axis is not None:
        raise NotImplementedError(
            f"cluster_axis={cfg.cluster_axis!r} shards the clusters over a "
            f"mesh; one card has none (ROADMAP Queue 1 item 15)")

    def one(params, b):
        return torch.func.grad_and_value(model.loss)(params, b, opts,
                                                     cfg.aux_weight)

    grads, losses = torch.func.vmap(one)(cluster_params, batch)
    flat_g = dict(leaves_with_paths(grads))
    del grads     # each gradient goes once it is applied
    new = {path: _sgd(p, flat_g.pop(path), cfg.inner_lr)
           for path, p in leaves_with_paths(cluster_params)}
    return rebuild(cluster_params, new), losses


# ---------------------------------------------------------------------------
# PoFEL consensus (Alg. 1, lines 2-5)
# ---------------------------------------------------------------------------

def _rows(leaf: torch.Tensor) -> torch.Tensor:
    """The (C, n) view of a stacked leaf (a copy only if it is not
    contiguous)."""
    return leaf.reshape(leaf.shape[0], -1).contiguous()


def _weighted_global(cluster_params: Any, lambdas: torch.Tensor,
                     dtype: str = "float32") -> Any:
    """Eq. 1: gw = Σ_c λ_c w^c, leaf by leaf. float32: the weighted
    aggregate kernel on each leaf's (C, n) view, cast back to the leaf's
    dtype; bfloat16: the reference's einsum in bfloat16 (the kernel
    accumulates in float32 only)."""
    acc = CONSENSUS_DTYPES[dtype]
    if acc == torch.float32:
        return _map(lambda leaf: ops.weighted_aggregate(
            _rows(leaf), lambdas).reshape(leaf.shape[1:]).to(leaf.dtype),
            cluster_params)
    lam = (lambdas / torch.sum(lambdas)).to(acc)
    return _map(lambda leaf: torch.einsum(
        "c,c...->...", lam, leaf.to(acc)).to(leaf.dtype), cluster_params)


def _similarities(cluster_params: Any, gw: Any,
                  eps: float = 1e-12) -> torch.Tensor:
    """Eq. 2 from per-leaf partials (the cosine partials kernel a leaf:
    <w_c, gw>, ‖w_c‖² and ‖gw‖²), summed over the leaves in their flatten
    order, then combined and clipped to [-1, 1]."""
    leaves_w, leaves_g = _leaves(cluster_params), _leaves(gw)
    C = leaves_w[0].shape[0]
    f32 = dict(dtype=torch.float32, device=leaves_w[0].device)
    dot, wsq = torch.zeros((C,), **f32), torch.zeros((C,), **f32)
    gsq = torch.zeros((), **f32)
    for w, g in zip(leaves_w, leaves_g):
        d, ws, gs = ops.cosine_partials(_rows(w), g.reshape(-1).contiguous())
        dot, wsq, gsq = dot + d, wsq + ws, gsq + gs
    return torch.clamp(dot / torch.clamp(torch.sqrt(wsq) * torch.sqrt(gsq),
                                         min=eps), -1.0, 1.0)


def consensus(cluster_params: Any, lambdas: torch.Tensor,
              btsv_history: torch.Tensor, cfg: PoFELTrainConfig,
              ) -> tuple[Any, torch.Tensor, ConsensusMetrics]:
    """Alg. 1 lines 2-5 (HCDS is host-side): (gw, new_history, metrics).
    All C honest clusters vote argmax-similarity; the BTSV tally still
    runs so vote weights and scores are produced for the ledger."""
    C = lambdas.shape[0]
    gw = _weighted_global(cluster_params, lambdas, cfg.consensus_dtype)
    sims = _similarities(cluster_params, gw)
    vote = int(torch.argmax(sims))
    votes = torch.full((C,), vote, dtype=torch.int32, device=sims.device)
    g_min = (1.0 - cfg.g_max) / (C - 1)
    p_row = torch.full((C,), g_min, dtype=torch.float32, device=sims.device)
    p_row[vote] = cfg.g_max
    P = p_row.expand(C, C)
    res, new_history = btsv_round(votes, P, btsv_history, cfg.btsv)
    metrics = ConsensusMetrics(torch.zeros((C,), device=sims.device), sims,
                               res.leader.to(torch.int32), res.weights,
                               res.scores)
    return gw, new_history, metrics


# ---------------------------------------------------------------------------
# Full PoFEL round: local step + consensus + outer update + redistribution
# ---------------------------------------------------------------------------

def pofel_round(model: Model, state: PoFELTrainState, batch: dict,
                lambdas: torch.Tensor, cfg: PoFELTrainConfig,
                opts: Optional[FwdOptions] = None,
                ) -> tuple[PoFELTrainState, ConsensusMetrics]:
    cluster_params, losses = local_step(model, state.cluster_params, batch,
                                        cfg, opts)
    gw, new_history, metrics = consensus(cluster_params, lambdas,
                                         state.btsv_history, cfg)
    del cluster_params
    if cfg.outer == "sgd1":
        # paper-faithful: the aggregated model is the next global model
        new_global, new_mom = gw, state.outer_momentum
    elif cfg.outer == "nesterov":
        # beyond-paper: Nesterov outer step on the pseudo-gradient
        def delta(gp, gw_leaf):
            return gp.to(torch.float32) - gw_leaf.to(torch.float32)

        new_mom = _map(lambda gp, g, mom: cfg.outer_momentum * mom
                       + delta(gp, g), state.global_params, gw,
                       state.outer_momentum)
        new_global = _map(
            lambda gp, g, mom: (gp.to(torch.float32) - cfg.outer_lr * (
                delta(gp, g) + cfg.outer_momentum * mom)).to(gp.dtype),
            state.global_params, gw, new_mom)
    else:
        raise ValueError(f"outer must be 'sgd1' or 'nesterov'; got "
                         f"{cfg.outer!r}")
    new_state = PoFELTrainState(
        _broadcast_clusters(new_global, cfg.n_clusters), new_global, new_mom,
        new_history, state.round + 1)
    return new_state, metrics._replace(loss=losses)


def train_step(model: Model, state: PoFELTrainState, batch: dict,
               cfg: PoFELTrainConfig, opts: Optional[FwdOptions] = None,
               ) -> tuple[PoFELTrainState, torch.Tensor]:
    """Plain FEL iteration (no consensus): the replicas move apart and the
    round counter stays."""
    cluster_params, losses = local_step(model, state.cluster_params, batch,
                                        cfg, opts)
    return state._replace(cluster_params=cluster_params), losses


__all__ = ["ConsensusMetrics", "PoFELTrainConfig", "PoFELTrainState",
           "consensus", "init_train_state", "local_step", "pofel_round",
           "train_state_from_jax", "train_step"]
