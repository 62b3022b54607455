"""BHFL runtime — the paper-faithful end-to-end loop (paper §3.1).

Port of ``repro.fl.hfl_runtime``. Per BCFL round k:
  1. every cluster runs `fel_iterations` of FEL (clients local-train,
     edge FedAvg) starting from the current global model,
  2. the N resulting intermediate models W(k) go through one PoFEL
     consensus round (HCDS → ME → vote submission → BTSV tally → block
     mint — the phase pipeline of ``repro_torch.core.phases``),
  3. the weighted global aggregate gw(k) (Eq. 1) becomes the next round's
     starting model, and the block is appended to every ledger.

The runtime is model-agnostic: a ``ModelAdapter`` (``repro_torch.fl.
adapters``) supplies init / local-train / eval / flatten / unflatten, so
the same consensus path drives the paper's MNIST MLP, a transformer or an
RWKV-6 LM. Models live on the runtime's ``device`` (the CUDA card unless
the caller asks for the CPU); ME runs there through the port's kernels,
and gw(k) is adopted there without a host roundtrip.

FEL runs on one of two engines (``BHFLConfig.engine``): ``"reference"``,
the paper-faithful loop of one client's SGD step at a time, or
``"batched"`` (``fl.batched_fel``), every client of every cluster in one
vmapped step, with the models kept as the stacked flat (N, D) W(k) that
ME takes. ``"auto"`` picks the batched engine when the adapter has a
batched train spec and the hierarchy has data, else the loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.btsv import BTSVConfig
from repro_torch.core.consensus import ConsensusRecord, PoFELConsensus
from repro_torch.core.phases import QuorumNotReached
from repro_torch.core.serialization import flatten_pytree, unflatten_pytree
from repro_torch.fl.adapters import MLPAdapter, ModelAdapter
from repro_torch.fl.batched_fel import engine_for
from repro_torch.fl.fedavg import fedavg
from repro_torch.fl.hierarchy import FELCluster
from repro_torch.models.mlp import MLPConfig
from repro_torch.obs import get_recorder

ENGINES = ("reference", "batched", "auto")


@dataclass
class BHFLConfig:
    n_nodes: int = 8
    clients_per_node: int = 5
    fel_iterations: int = 3         # FEL iterations per BCFL round (paper §7.1)
    local_epochs: int = 1
    batch_size: int = 32
    lr: float = 1e-3
    momentum: float = 0.9
    decay: float = 5e-4             # half the lr, per paper
    mlp: MLPConfig = field(default_factory=MLPConfig)
    btsv: BTSVConfig = field(default_factory=BTSVConfig)
    g_max: float = 0.99
    seed: int = 0
    engine: str = "reference"       # "reference" | "batched" | "auto"
    # pad the batched engine's client/sample/step/batch dims to the next
    # power of two (bit-exact padding; repro_torch.fl.batched_fel module
    # doc); costs masked device compute per round, so it is opt-in
    shape_bucketing: bool = False

    def default_adapter(self, device: torch.device) -> MLPAdapter:
        """The paper's workload: the MNIST MLP with §7.1 hyperparameters."""
        return MLPAdapter(cfg=self.mlp, local_epochs=self.local_epochs,
                          batch_size=self.batch_size, lr=self.lr,
                          momentum=self.momentum, decay=self.decay,
                          device=device)


@dataclass
class RoundMetrics:
    round: int
    leader_id: int              # -1 when the round aborted (quorum timeout)
    test_accuracy: float
    test_loss: float
    mean_similarity: float
    consensus: Optional[ConsensusRecord]   # None for an aborted round


class AllNodesPlagiarizeError(RuntimeError):
    """Every BCFL node was configured as a plagiarist — there is no honest
    model to copy, and HCDS would reject every reveal anyway (§3.2)."""


class BHFLRuntime:
    """Drives FEL clusters + PoFEL consensus for a full learning task.

    ``adapter`` chooses the model family (default: the paper's MNIST
    MLP); the clusters' client datasets must match its batch format.
    ``device=None`` runs on the CUDA card and raises if there is none;
    pass ``device="cpu"`` to run on the CPU. A given ``adapter`` must
    live on the same device. ``committee`` (a
    ``repro_torch.core.committee.Committee``) scopes the runtime to one
    shard of a consortium.
    """

    def __init__(self, clusters: List[FELCluster], cfg: BHFLConfig,
                 test_set: Optional[Any] = None,
                 adapter: Optional[ModelAdapter] = None,
                 device: Any = None, committee: Optional[Any] = None):
        if len(clusters) != cfg.n_nodes:
            raise ValueError(f"{len(clusters)} clusters for "
                             f"n_nodes={cfg.n_nodes}")
        if cfg.engine not in ENGINES:
            raise ValueError(f"unknown engine {cfg.engine!r}; "
                             f"choose from {ENGINES}")
        self.device = resolve_device(device)
        self.clusters = clusters
        self.cfg = cfg
        self.test_set = test_set
        self.adapter = (adapter if adapter is not None
                        else cfg.default_adapter(self.device))
        if torch.device(self.adapter.device) != self.device:
            raise ValueError(f"adapter runs on {self.adapter.device} but the "
                             f"runtime on {self.device}")
        # committee scopes this runtime to one shard of a consortium:
        # consensus runs over the committee's member set with
        # committee-derived signing keys, and round spans carry the
        # committee id so traces drill per-shard
        self.committee = committee
        self.consensus = PoFELConsensus(cfg.n_nodes, cfg.btsv,
                                        g_max=cfg.g_max, committee=committee)
        # the generator lives where the adapter draws its init: an LM on
        # its device (Model.init refuses another), the MLP on the CPU
        init_device = getattr(self.adapter, "init_device", self.device)
        self.global_params = self.adapter.init(
            torch.Generator(device=init_device).manual_seed(cfg.seed))
        self._check_adapter_layout()
        self.history: List[RoundMetrics] = []
        # adversaries: plagiarists copy an honest model in FEL, vote hooks
        # act at consensus time
        self.plagiarists: set[int] = set()
        self.vote_hook: Optional[Callable] = None
        # fault environment (repro_torch.sim.network.SimEnv) — set by the
        # scenario wiring in api.run_bhfl; None = ideal synchronous world
        self.env: Optional[Any] = None
        # -- FEL engine selection -------------------------------------------
        self._engine = None
        self._global_flat: Optional[torch.Tensor] = None
        if cfg.engine in ("batched", "auto"):
            try:
                self._engine = engine_for(self.adapter, clusters,
                                          cfg.fel_iterations,
                                          self.global_params,
                                          bucket=cfg.shape_bucketing)
            except ValueError:
                # degenerate hierarchy (e.g. every shard empty): 'auto'
                # falls back to the reference loop, 'batched' surfaces it
                if cfg.engine == "batched":
                    raise
                self._engine = None
            if self._engine is None and cfg.engine == "batched":
                raise ValueError(
                    f"engine='batched' requires the adapter to provide "
                    f"batched_train_spec(); "
                    f"{getattr(self.adapter, 'name', type(self.adapter).__name__)!r} "
                    f"does not — use engine='auto' to fall back")
            if self._engine is not None:
                # models live in stacked flat form on the device across
                # rounds
                self._global_flat = flatten_pytree(self.global_params)

    @property
    def engine(self) -> str:
        """Which FEL engine actually runs ('reference' or 'batched')."""
        return "batched" if self._engine is not None else "reference"

    @property
    def global_params(self) -> Any:
        return self._global_params

    @global_params.setter
    def global_params(self, value: Any) -> None:
        # keep the batched engine's flat state in sync so external
        # warm-starts (rt.global_params = ...) take effect there
        self._global_params = value
        if getattr(self, "_engine", None) is not None:
            self._global_flat = flatten_pytree(value)

    def _check_adapter_layout(self) -> None:
        """ME produces gw(k) in the canonical sorted-keypath layout and the
        runtime adopts it through ``adapter.unflatten``, so an adapter whose
        flatten deviates from that layout would silently scramble weights
        every round. Catch it once, at init."""
        probe = self.adapter.flatten(self.global_params)
        canonical = flatten_pytree(self.global_params)
        if probe.shape != canonical.shape or not torch.equal(probe,
                                                             canonical):
            raise ValueError(
                f"adapter {self.adapter.name!r} flattens parameters in a "
                "non-canonical order; flatten/unflatten must use the "
                "sorted-keypath layout of core.serialization.flatten_pytree")

    # -- one FEL phase inside cluster `c` (reference engine) -----------------
    def _run_fel(self, cluster: FELCluster, start_params: Any,
                 round_seed: int) -> Any:
        params = start_params
        for it in range(self.cfg.fel_iterations):
            locals_, sizes = [], []
            for client in cluster.clients:
                if client.data_size == 0:
                    continue    # empty shard: zero FedAvg weight, skip
                p, _ = self.adapter.local_train(
                    params, client,
                    seed=round_seed * 1000 + client.client_id * 10 + it)
                locals_.append(p)
                sizes.append(client.data_size)
            if not locals_:
                # a dataless cluster keeps the incoming global model; its
                # consensus weight (|DS_m| = 0) already zeroes it in Eq. 1
                return params
            params = fedavg(locals_, sizes)
        return params

    # -- W(k) production, per engine ----------------------------------------
    def _fel_models_reference(self, round_seed: int,
                              down: Optional[set] = None) -> List[Any]:
        down = down or set()
        models: List[Any] = []
        for cluster in self.clusters:
            if cluster.node_id in down:
                # a crashed node trains nothing; the stale global model
                # stands in (it is never revealed, so it cannot be voted)
                models.append(self.global_params)
            elif cluster.node_id in self.plagiarists:
                models.append(None)  # filled in below by copying a victim
            else:
                models.append(self._run_fel(cluster, self.global_params,
                                            round_seed=round_seed))
        # plagiarists copy the first honest live model they "received"
        honest_ids = [i for i, m in enumerate(models)
                      if m is not None and i not in down]
        if any(m is None for m in models) and not honest_ids:
            raise QuorumNotReached(
                "every honest node is down — no model for the "
                "plagiarist(s) to copy; round cannot proceed")
        return [dict(models[honest_ids[0]]) if m is None else m
                for m in models]

    def _fel_models_batched(self, round_seed: int,
                            down: Optional[set] = None) -> List[Any]:
        """The batched engine's stacked (N, D) W(k); its rows go to
        consensus as they are (a flat vector is itself a model tree), a
        plagiarist's row a copy of the first honest live one. A crashed
        node's row is the stale global model, as on the reference path
        (still on the device)."""
        down = down or set()
        W = self._engine.run_round(self._global_flat, round_seed)
        flags = [c.node_id in self.plagiarists for c in self.clusters]
        victim = next((i for i, f in enumerate(flags)
                       if not f and i not in down), None)
        if victim is None and any(flags):
            raise QuorumNotReached(
                "every honest node is down — no model for the "
                "plagiarist(s) to copy; round cannot proceed")
        return [self._global_flat if i in down else
                (W[victim] if f else W[i]) for i, f in enumerate(flags)]

    # -- one BCFL round ------------------------------------------------------
    def run_round(self) -> RoundMetrics:
        cfg = self.cfg
        k = self.consensus.round
        node_ids = {c.node_id for c in self.clusters}
        if node_ids and node_ids <= self.plagiarists:
            raise AllNodesPlagiarizeError(
                f"all {cfg.n_nodes} nodes are plagiarists — at least one "
                f"honest node must train a model for round {k}")
        env = self.env
        rec = get_recorder()
        # the top-level round span: its children (begin_round, fel, the
        # consensus span opened inside run_round, adopt_global, evaluate,
        # end_round) account for the round's wall time
        com_attrs = ({} if self.committee is None
                     else {"committee": self.committee.committee_id})
        rec.open_span("round", cat="runtime", round=k, sim_env=env,
                      **com_attrs)
        down: set = set()
        if env is not None:
            with rec.span("begin_round", round=k, sim_env=env):
                env.begin_round(k)
            down = set(range(cfg.n_nodes)) - env.alive()
        round_seed = cfg.seed + k + 1
        sizes = [float(c.data_size) for c in self.clusters]
        try:
            with rec.span("fel", round=k, sim_env=env, engine=self.engine):
                if self._engine is not None:
                    models = self._fel_models_batched(round_seed, down=down)
                else:
                    models = self._fel_models_reference(round_seed,
                                                        down=down)
            record = self.consensus.run_round(models, sizes,
                                              vote_hook=self.vote_hook,
                                              env=env)
        except QuorumNotReached as e:
            if env is None:     # impossible without fault injection
                rec.close_span(error=type(e).__name__)
                raise
            # liveness gap: no block this round; global model unchanged
            self.consensus.skip_round()
            env.note("round_aborted", round=k, reason=str(e))
            metrics = RoundMetrics(k, -1, float("nan"), float("nan"),
                                   float("nan"), None)
            self.history.append(metrics)
            with rec.span("end_round", round=k, sim_env=env):
                env.end_round(k, metrics, aborted=True)
            rec.close_span(sim_now=None, error="QuorumNotReached",
                           aborted=True)
            return metrics
        except BaseException as e:
            rec.close_span(error=type(e).__name__)
            raise

        # adopt gw(k) as the next global model (it stays on the device)
        with rec.span("adopt_global", round=k, sim_env=env):
            if self._engine is not None:
                # the flat form is the batched engine's round state (set
                # both here, past the syncing setter)
                self._global_flat = record.global_model
                self._global_params = unflatten_pytree(self._global_flat,
                                                       self.global_params)
            else:
                self.global_params = self.adapter.unflatten(
                    record.global_model, self.global_params)

        acc, loss = float("nan"), float("nan")
        if self.test_set is not None:
            with rec.span("evaluate", round=k, sim_env=env):
                acc, loss = self.adapter.evaluate(self.global_params,
                                                  self.test_set)

        metrics = RoundMetrics(k, record.leader_id, acc, loss,
                               float(np.mean(record.similarities)), record)
        self.history.append(metrics)
        if env is not None:
            with rec.span("end_round", round=k, sim_env=env):
                env.end_round(k, metrics, aborted=False)
        rec.close_span(aborted=False)
        return metrics

    def run(self, n_rounds: int) -> List[RoundMetrics]:
        return [self.run_round() for _ in range(n_rounds)]

    # -- leader statistics (paper Fig. 6b) -----------------------------------
    def leader_counts(self) -> Dict[int, int]:
        counts: Dict[int, int] = {i: 0 for i in range(self.cfg.n_nodes)}
        for m in self.history:
            if m.leader_id >= 0:    # aborted rounds elected no leader
                counts[m.leader_id] += 1
        return counts
