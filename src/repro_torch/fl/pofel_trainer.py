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

:func:`abstract_train_state` gives the state's shapes and dtypes on the
meta device (the dry run's, ``repro_torch.launch.specs``).

On a mesh the state and batch are DTensors (laid out by
``models.sharding``; ``launch.specs`` builds them) and the round is a
DTensor program. ``torch.func`` takes no DTensor, so a rank's clusters
go one at a time through ``torch.autograd.grad`` of ``Model.loss``:
with ``cluster_axis=None`` a rank holds every cluster, each sharded over
the mesh as one model is; with ``cluster_axis`` (a mesh axis, the zero3
profile's ``"data"``) it holds its own shard of the clusters, each a
DTensor over the mesh's other axes, as the reference's
``vmap(spmd_axis_name=...)`` splits them. The consensus gathers the C
rows over that axis first, then runs Eq. 1 and Eq. 2 leaf by leaf
through the ME kernels' custom ops on the shards (Eq. 2's partials
summed in rank order, ``kernels._dtensor.ordered_sum``) and the tally on
the whole (C,) similarities. On plain tensors ``cluster_axis`` is a
layout and changes nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.btsv import BTSVConfig, btsv_round, init_history
from repro_torch.core.serialization import leaves_with_paths, rebuild
from repro_torch.core.serialization import map_tree as _map
from repro_torch.kernels import ops
from repro_torch.kernels._dtensor import ordered_sum
from repro_torch.models.mesh_ops import (contiguous_stride,
                                         implicit_replication, is_dtensor,
                                         on_mesh, replicated, whole)
from repro_torch.models.model_api import Model
from repro_torch.models.params_io import tree_from_numpy
from repro_torch.models.transformer import FwdOptions
from repro_torch.obs import get_recorder

CONSENSUS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class PoFELTrainConfig:
    n_clusters: int = 8
    cluster_axis: Optional[str] = None  # shard the cluster dim over this
                                        # mesh axis (zero3: "data")
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


def abstract_train_state(model: Model,
                         cfg: PoFELTrainConfig) -> PoFELTrainState:
    """:func:`init_train_state`'s shapes and dtypes as meta tensors,
    nothing allocated: the replicas (C, ...) as ``expand`` views of the
    global model, float32 momenta, the BTSV history and the round."""
    params = model.abstract_params()
    return PoFELTrainState(
        cluster_params=_broadcast_clusters(params, cfg.n_clusters),
        global_params=params,
        outer_momentum=_map(lambda t: torch.empty(
            t.shape, dtype=torch.float32, device="meta"), params),
        btsv_history=init_history(cfg.n_clusters, cfg.btsv).to("meta"),
        round=torch.empty((), dtype=torch.int32, device="meta"),
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
    Returns (new replicas, losses (C,)). DTensor replicas take the mesh
    path (:func:`_local_step_mesh`).

    Traced as a ``local_step`` span holding ``forward`` (``Model.loss``,
    run once under ``vmap``) and ``update`` (the SGD update): its time
    outside the two is the backward, autograd's sums of the stacked
    leaves' gradients included. The mesh path opens a ``forward`` a
    cluster and no ``update``."""
    rec = get_recorder()
    with rec.span("local_step", cat="trainer"):
        if any(is_dtensor(t) for t in _leaves(cluster_params)):
            return _local_step_mesh(model, cluster_params, batch, cfg, opts)

        def loss(params, b):
            with rec.span("forward", cat="trainer"):
                return model.loss(params, b, opts, cfg.aux_weight)

        def one(params, b):
            return torch.func.grad_and_value(loss)(params, b)

        grads, losses = torch.func.vmap(one)(cluster_params, batch)
        flat_g = dict(leaves_with_paths(grads))
        del grads     # each gradient goes once it is applied
        with rec.span("update", cat="trainer"):
            new = {path: _sgd(p, flat_g.pop(path), cfg.inner_lr)
                   for path, p in leaves_with_paths(cluster_params)}
        return rebuild(cluster_params, new), losses


def _cluster_step(model: Model, params: dict, batch: dict,
                  cfg: PoFELTrainConfig, opts: Optional[FwdOptions]
                  ) -> tuple[dict, torch.Tensor]:
    """One cluster's FedSGD step under autograd (DTensors): (new params,
    loss)."""
    flat = [(p, t.detach().requires_grad_(t.is_floating_point()))
            for p, t in leaves_with_paths(params)]
    leaves = [t for _, t in flat if t.requires_grad]
    with implicit_replication():
        with get_recorder().span("forward", cat="trainer"):
            loss = model.loss(rebuild(params, dict(flat)), batch, opts,
                              cfg.aux_weight)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        new = {}
        for p, t in flat:
            g = next(grads) if t.requires_grad else None
            new[p] = t.detach() if g is None else (
                t.detach().to(torch.float32)
                - cfg.inner_lr * g.to(torch.float32)).to(t.dtype)
    return rebuild(params, new), replicated(loss.detach())


def _axes(axis) -> tuple:
    """``cluster_axis`` as a tuple of mesh axis names."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _on_submesh(t: torch.Tensor, axis):
    """A DTensor sharded over ``axis`` (a mesh axis, or a tuple of them,
    major first) on its first dim → its local shard as a DTensor over
    the mesh's other axes (their placements kept)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = t.device_mesh
    names = list(mesh.mesh_dim_names)
    axes = [names.index(a) for a in _axes(axis)]
    want = [Shard(0) if d in axes else p for d, p in enumerate(t.placements)]
    if list(t.placements) != want:
        t = t.redistribute(mesh, want)
    rest = tuple(n for d, n in enumerate(names) if d not in axes)
    sub = mesh[rest[0]] if len(rest) == 1 else mesh[rest]
    local = t.to_local()
    shape = (local.shape[0],) + tuple(t.shape[1:])
    return DTensor.from_local(local, sub, [p for d, p in enumerate(
        t.placements) if d not in axes], run_check=False, shape=shape,
        stride=contiguous_stride(shape))


def _from_submesh(t: torch.Tensor, mesh, n: int, axis):
    """The inverse of :func:`_on_submesh`: the ranks' shards along
    ``axis`` (first dim, ``n`` in all) as one DTensor over ``mesh``."""
    from torch.distributed.tensor import DTensor, Shard
    names = list(mesh.mesh_dim_names)
    axes = [names.index(a) for a in _axes(axis)]
    rest = iter(t.placements)
    placements = [Shard(0) if d in axes else next(rest)
                  for d in range(mesh.ndim)]
    shape = (n,) + tuple(t.shape[1:])
    return DTensor.from_local(t.to_local(), mesh, placements,
                              run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def _local_step_mesh(model: Model, cluster_params: Any, batch: dict,
                     cfg: PoFELTrainConfig, opts: Optional[FwdOptions]
                     ) -> tuple[Any, torch.Tensor]:
    """:func:`local_step` on DTensor replicas, a rank's clusters one at a
    time; with ``cluster_axis`` each rank takes its own shard of them."""
    axis = cfg.cluster_axis
    flat = leaves_with_paths(cluster_params)
    first = flat[0][1]
    if axis is not None and not set(_axes(axis)) <= set(
            first.device_mesh.mesh_dim_names):
        raise ValueError(f"cluster_axis={axis!r} is not an axis of the "
                         f"mesh {first.device_mesh.mesh_dim_names}")
    if axis is not None:
        mine = {p: _on_submesh(t, axis) for p, t in flat}
        local_batch = {k: _on_submesh(v, axis) for k, v in batch.items()}
    else:
        mine, local_batch = dict(flat), batch
    n = next(iter(mine.values())).shape[0]
    # each cluster's new leaves written into the new replicas as they
    # come, so that one cluster's gradients are held at a time
    out = {p: torch.empty_like(t) for p, t in mine.items()}
    losses = []
    for c in range(n):
        params = rebuild(cluster_params, {p: t[c] for p, t in mine.items()})
        new, loss = _cluster_step(model, params,
                                  {k: v[c] for k, v in local_batch.items()},
                                  cfg, opts)
        with implicit_replication():
            for p, t in leaves_with_paths(new):
                out[p].select(0, c).copy_(t)
        losses.append(loss)
        del new
    with implicit_replication():
        losses = torch.stack(losses)
    if axis is not None:
        mesh, C = first.device_mesh, first.shape[0]
        out = {p: _from_submesh(t, mesh, C, axis) for p, t in out.items()}
        losses = _from_submesh(losses, mesh, C, axis)
    return rebuild(cluster_params, out), losses


# ---------------------------------------------------------------------------
# PoFEL consensus (Alg. 1, lines 2-5)
# ---------------------------------------------------------------------------

def _rows(leaf: torch.Tensor) -> torch.Tensor:
    """The (C, n) view of a stacked leaf (a copy only if it is not
    contiguous). A DTensor leaf has its C rows gathered whole first, and
    stays sharded on its second dim at most: the view merges the dims
    past the first, and DTensor (torch 2.11) refuses to merge a sharded
    dim past the first of them."""
    if is_dtensor(leaf):
        from torch.distributed.tensor import Replicate, Shard
        rows = [p if p == Shard(1) else Replicate()
                for p in leaf.placements]
        if list(leaf.placements) != rows:
            leaf = leaf.redistribute(leaf.device_mesh, rows)
    return leaf.reshape(leaf.shape[0], -1).contiguous()


def _as_rows_columns(gw: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """A DTensor aggregate (n,) laid out as the columns of its (C, n)
    rows, so that it takes the leaf's shape again (DTensor cannot view a
    dim that two mesh dims shard); a plain tensor as it is."""
    if not is_dtensor(gw):
        return gw
    from torch.distributed.tensor import Replicate, Shard
    want = [Shard(0) if p == Shard(1) else Replicate()
            for p in rows.placements]
    if list(gw.placements) == want:
        return gw
    return gw.redistribute(gw.device_mesh, want)


def _weighted_global(cluster_params: Any, lambdas: torch.Tensor,
                     dtype: str = "float32") -> Any:
    """Eq. 1: gw = Σ_c λ_c w^c, leaf by leaf. float32: the weighted
    aggregate kernel on each leaf's (C, n) view, cast back to the leaf's
    dtype; bfloat16: the reference's einsum in bfloat16 (the kernel
    accumulates in float32 only)."""
    acc = CONSENSUS_DTYPES[dtype]
    if acc == torch.float32:
        def one(leaf):
            rows = _rows(leaf)
            gw = _as_rows_columns(ops.weighted_aggregate(rows, lambdas),
                                  rows)
            return gw.reshape(leaf.shape[1:]).to(leaf.dtype)
        return _map(one, cluster_params)
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
        d, ws, gs = (ordered_sum(t) for t in ops.cosine_partials(
            _rows(w), g.reshape(-1).contiguous()))
        dot, wsq, gsq = dot + d, wsq + ws, gsq + gs
    return torch.clamp(dot / torch.clamp(torch.sqrt(wsq) * torch.sqrt(gsq),
                                         min=eps), -1.0, 1.0)


def consensus(cluster_params: Any, lambdas: torch.Tensor,
              btsv_history: torch.Tensor, cfg: PoFELTrainConfig,
              ) -> tuple[Any, torch.Tensor, ConsensusMetrics]:
    """Alg. 1 lines 2-5 (HCDS is host-side): (gw, new_history, metrics).
    All C honest clusters vote argmax-similarity; the BTSV tally still
    runs so vote weights and scores are produced for the ledger. On
    DTensor replicas gw is a DTensor tree, the tally runs on the whole
    similarities, the metrics are plain tensors and the history a
    replicated DTensor. Traced as a ``consensus`` span."""
    with get_recorder().span("consensus", cat="trainer"):
        C = lambdas.shape[0]
        if any(is_dtensor(t) for t in _leaves(cluster_params)):
            with implicit_replication():
                gw = _weighted_global(cluster_params, lambdas,
                                      cfg.consensus_dtype)
                sims = whole(_similarities(cluster_params, gw))
            new_history, metrics = _tally(sims, whole(btsv_history), cfg, C)
            if is_dtensor(btsv_history):
                new_history = _replicated_like(new_history, btsv_history)
            return gw, new_history, metrics
        gw = _weighted_global(cluster_params, lambdas, cfg.consensus_dtype)
        sims = _similarities(cluster_params, gw)
        return (gw, *_tally(sims, btsv_history, cfg, C))


def _replicated_like(t: torch.Tensor, like: torch.Tensor):
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _tally(sims: torch.Tensor, btsv_history: torch.Tensor,
           cfg: PoFELTrainConfig, C: int) -> tuple:
    """The votes (all for the argmax), the BTSV tally and the metrics:
    (new_history, metrics)."""
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
    return new_history, metrics


# ---------------------------------------------------------------------------
# Full PoFEL round: local step + consensus + outer update + redistribution
# ---------------------------------------------------------------------------

def pofel_round(model: Model, state: PoFELTrainState, batch: dict,
                lambdas: torch.Tensor, cfg: PoFELTrainConfig,
                opts: Optional[FwdOptions] = None,
                ) -> tuple[PoFELTrainState, ConsensusMetrics]:
    """One round, traced as a ``pofel_round`` span around the
    ``local_step`` and ``consensus`` spans."""
    with get_recorder().span("pofel_round", cat="trainer"):
        cluster_params, losses = local_step(model, state.cluster_params,
                                            batch, cfg, opts)
        gw, new_history, metrics = consensus(cluster_params, lambdas,
                                             state.btsv_history, cfg)
        del cluster_params
        with on_mesh(gw):
            return _outer(state, gw, new_history, metrics._replace(
                loss=whole(losses)), cfg)


def _outer(state: PoFELTrainState, gw: Any, new_history: torch.Tensor,
           metrics: ConsensusMetrics, cfg: PoFELTrainConfig
           ) -> tuple[PoFELTrainState, ConsensusMetrics]:
    """The outer update and the redistribution of the new global model."""
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
    return new_state, metrics


def train_step(model: Model, state: PoFELTrainState, batch: dict,
               cfg: PoFELTrainConfig, opts: Optional[FwdOptions] = None,
               ) -> tuple[PoFELTrainState, torch.Tensor]:
    """Plain FEL iteration (no consensus): the replicas move apart and the
    round counter stays."""
    cluster_params, losses = local_step(model, state.cluster_params, batch,
                                        cfg, opts)
    return state._replace(cluster_params=cluster_params), losses


__all__ = ["ConsensusMetrics", "PoFELTrainConfig", "PoFELTrainState",
           "abstract_train_state", "consensus", "init_train_state", "local_step", "pofel_round",
           "train_state_from_jax", "train_step"]
