"""``repro_torch.api`` — the facade over the port's BHFL system (§3.1).

Port of ``repro.api.run_bhfl``, for the paper's MNIST MLP and the LM
families, in the ideal setting or under a simulator scenario, on one
committee or sharded into a consortium:

    from repro_torch import api

    run = api.run_bhfl(model="mlp", n_nodes=8, clients_per_node=5,
                       fel_iterations=3, rounds=3, seed=0)   # on the card
    run.chain_valid, run.chain_height, run.history[-1].test_accuracy
    api.run_bhfl(model="rwkv6", rounds=2)          # or "transformer"
    api.run_bhfl(engine="batched")       # every client in one vmapped step
    api.run_bhfl(scenario="byzantine_third").scenario_report.summary()
    api.run_bhfl(scenario="consortium_64")   # 4 committees of 16

One call publishes the task, negotiates it (Stackelberg), partitions the
data into the FEL hierarchy, and runs PoFEL rounds on ``device`` — the
CUDA card unless the caller passes ``device="cpu"``. ``engine`` picks the
FEL engine: ``"reference"`` (the default, one client's SGD step at a
time), ``"batched"`` (``fl.batched_fel``: every client of every cluster
in one ``torch.func.vmap``-ed step, the LM kernels launched once a layer
for all of them) or ``"auto"`` (batched where the adapter has a batched
train spec).

``scenario=`` (a ``repro_torch.sim`` scenario name or ``Scenario``) or
``faults=`` (a prebuilt ``repro_torch.sim.SimEnv``) sends the consensus
rounds over the seeded fault-injecting bus, and the run carries
``run.scenario_report``. ``committees`` > 1 shards the nodes into that
many committee-scoped PoFEL instances with cross-shard checkpoints every
``checkpoint_interval`` rounds (``repro_torch.fl.consortium``).
"""

from __future__ import annotations

import dataclasses
import difflib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.btsv import BTSVConfig
from repro_torch.core.consensus import ConsensusRecord, PoFELConsensus
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.data.tokens import TokenDataset, make_token_dataset
from repro_torch.fl.adapters import (LMAdapter, MLPAdapter, ModelAdapter,
                                     make_adapter, params_from_jax,
                                     rwkv6_adapter, transformer_adapter)
from repro_torch.fl.batched_fel import BatchedFELEngine, BatchedTrainSpec
from repro_torch.fl.hfl_runtime import (AllNodesPlagiarizeError, BHFLConfig,
                                        BHFLRuntime, RoundMetrics)
from repro_torch.fl.hierarchy import build_hierarchy
from repro_torch.fl.sharded_consensus import ShardedModelEvaluation
from repro_torch.fl.task import (LearningTask, RewardLedger, TaskAgreement,
                                 negotiate_task)
from repro_torch.obs import get_recorder

__all__ = [
    "run_bhfl", "BHFLRun",
    "LearningTask", "TaskAgreement", "RewardLedger", "negotiate_task",
    "BHFLConfig", "BHFLRuntime", "RoundMetrics", "build_hierarchy",
    "MLPAdapter", "LMAdapter", "ModelAdapter", "make_adapter",
    "transformer_adapter", "rwkv6_adapter", "params_from_jax",
    "PoFELConsensus", "ConsensusRecord", "BTSVConfig",
    "AllNodesPlagiarizeError", "make_mnist_like", "make_token_dataset",
    "TokenDataset", "ShardedModelEvaluation", "BatchedFELEngine",
    "BatchedTrainSpec",
]


@dataclass
class BHFLRun:
    """Everything a finished (or stopped) BHFL task produced."""

    task: LearningTask
    agreement: TaskAgreement
    rewards: RewardLedger
    runtime: BHFLRuntime
    history: List[RoundMetrics] = field(default_factory=list)
    # set when the run was driven through a repro_torch.sim scenario/fault
    # env
    scenario_report: Optional[Any] = None
    # metrics rollup from the active obs recorder (None when tracing off)
    obs: Optional[Dict[str, Any]] = None

    @property
    def chain_height(self) -> int:
        return self.runtime.consensus.ledgers[0].height

    @property
    def chain_valid(self) -> bool:
        return all(led.verify_chain()
                   for led in self.runtime.consensus.ledgers)

    @property
    def leader_counts(self) -> Dict[int, int]:
        return self.runtime.leader_counts()


def _default_task(max_rounds: int) -> LearningTask:
    return LearningTask(
        task_id="bhfl-task-0", publisher_id="model-owner-0",
        description="BHFL learning task (repro.api default)",
        target_loss=0.0, max_rounds=max_rounds, block_reward=10.0)


# every keyword run_bhfl itself accepts, for the did-you-mean hint
_RUN_BHFL_KWARGS = frozenset((
    "task", "model", "data", "cfg", "n_nodes", "clients_per_node",
    "fel_iterations", "rounds", "engine", "distribution", "gamma", "mu",
    "seed", "vote_hook", "plagiarists", "on_round", "scenario", "faults",
    "committees", "checkpoint_interval", "device"))
# BHFLConfig fields not already exposed as explicit run_bhfl kwargs
_CFG_OVERRIDES = frozenset(
    f.name for f in dataclasses.fields(BHFLConfig)) - _RUN_BHFL_KWARGS


def _check_overrides(overrides: Dict[str, Any], cfg_given: bool) -> None:
    """Reject unknown keyword arguments loudly (a typo'd option silently
    swallowed by ``**overrides`` would run another configuration than the
    caller believes)."""
    if not overrides:
        return
    unknown = set(overrides) - _CFG_OVERRIDES
    if unknown:
        hints = []
        for k in sorted(unknown):
            close = difflib.get_close_matches(
                k, sorted(_CFG_OVERRIDES | _RUN_BHFL_KWARGS), n=1)
            hints.append(k + (f" (did you mean {close[0]!r}?)"
                              if close else ""))
        raise TypeError(
            f"run_bhfl() got unexpected keyword argument(s): "
            f"{', '.join(hints)}; valid BHFLConfig overrides are "
            f"{sorted(_CFG_OVERRIDES)}")
    if cfg_given:
        raise ValueError(
            f"config overrides {sorted(overrides)} conflict with an "
            f"explicit cfg=; set them on the BHFLConfig instead")


def _default_data(adapter: ModelAdapter, seed: int) -> Tuple[Any, Any]:
    """Per-family synthetic (train, test) when the caller brings no data."""
    if isinstance(adapter, LMAdapter):
        return make_token_dataset(n_seqs=256, seq_len=16,
                                  vocab_size=adapter.arch.vocab_size,
                                  seed=seed)
    return make_mnist_like(n_train=4000, n_test=600, seed=seed)


def run_bhfl(task: Optional[LearningTask] = None,
             model: "str | ModelAdapter" = "mlp",
             data: Optional[Tuple[Any, Any]] = None,
             *,
             cfg: Optional[BHFLConfig] = None,
             n_nodes: Optional[int] = None,
             clients_per_node: Optional[int] = None,
             fel_iterations: Optional[int] = None,
             rounds: Optional[int] = None,
             engine: Optional[str] = None,
             distribution: str = "iid",
             gamma: Optional[Dict[int, float]] = None,
             mu: Optional[Dict[int, float]] = None,
             seed: Optional[int] = None,
             vote_hook: Optional[Callable] = None,
             plagiarists: Sequence[int] = (),
             on_round: Optional[Callable[[RoundMetrics], None]] = None,
             scenario: Optional[Any] = None,
             faults: Optional[Any] = None,
             committees: Optional[int] = None,
             checkpoint_interval: Optional[int] = None,
             device: Any = None,
             **overrides: Any,
             ) -> BHFLRun:
    """Publish → negotiate → build hierarchy → run PoFEL rounds → settle.

    Arguments follow ``repro.api.run_bhfl``; ``device`` picks where the
    models train and ME runs (``None`` is the CUDA card and raises if
    there is none; ``"cpu"`` runs on the CPU). ``model`` is ``"mlp"``
    (trained with ``cfg``'s §7.1 hyperparameters), ``"transformer"`` or
    ``"rwkv6"`` (the CPU-scale LM adapters with their own LM defaults and
    the vocab of the caller's token data), or an adapter on ``device``.
    Data defaults to ``make_mnist_like(4000, 600, seed)`` for the MLP and
    ``make_token_dataset(256, 16, vocab, seed)`` for an LM; token data
    takes the "iid" distribution only. ``engine`` is ``"reference"`` (the
    default), ``"batched"`` or ``"auto"`` (module doc).

    ``scenario`` supplies sizing defaults (nodes, clients, FEL iterations,
    rounds, and for the MLP ``make_mnist_like(sc.n_train, sc.n_test)``)
    that explicit arguments override; it excludes ``faults``.
    ``committees`` defaults to the scenario's (1 without one) and
    ``checkpoint_interval`` likewise; ``faults`` does not combine with
    ``committees`` > 1.
    """
    _check_overrides(overrides, cfg_given=cfg is not None)
    sc = None
    if scenario is not None:
        if faults is not None:
            raise ValueError("pass scenario= or faults=, not both")
        from repro_torch.sim import Scenario, get_scenario
        sc = get_scenario(scenario) if isinstance(scenario, str) \
            else scenario
        if not isinstance(sc, Scenario):
            raise TypeError(f"scenario= must be a name or Scenario, "
                            f"got {type(sc).__name__}")
        # scenario sizing fills whatever the caller left unspecified
        if cfg is None:
            n_nodes = n_nodes if n_nodes is not None else sc.n_nodes
            clients_per_node = (clients_per_node if clients_per_node
                                is not None else sc.clients_per_node)
            fel_iterations = (fel_iterations if fel_iterations is not None
                              else sc.fel_iterations)
        rounds = rounds if rounds is not None else sc.rounds
    device = resolve_device(device)
    if cfg is None:
        cfg = BHFLConfig(n_nodes=n_nodes if n_nodes is not None else 6,
                         clients_per_node=clients_per_node
                         if clients_per_node is not None else 4,
                         fel_iterations=fel_iterations
                         if fel_iterations is not None else 2,
                         seed=seed if seed is not None else 0,
                         engine=engine if engine is not None else "reference")
    else:
        for kwarg, val, cfg_val in (
                ("n_nodes", n_nodes, cfg.n_nodes),
                ("clients_per_node", clients_per_node, cfg.clients_per_node),
                ("fel_iterations", fel_iterations, cfg.fel_iterations),
                ("engine", engine, cfg.engine),
                ("seed", seed, cfg.seed)):
            if val is not None and val != cfg_val:
                raise ValueError(
                    f"{kwarg}={val} conflicts with cfg.{kwarg}={cfg_val}; "
                    f"set it on cfg or drop the kwarg")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    n_nodes = cfg.n_nodes
    seed = cfg.seed     # one seed governs data, gamma draws, and init

    # resolve the adapter. BHFLConfig's training fields are the paper's
    # MLP hyperparameters, so they drive the MLP adapter only; named LM
    # adapters keep their own LM-tuned defaults (customize by passing an
    # adapter instance) and size their vocab from the caller's token data.
    if model == "mlp":
        adapter: ModelAdapter = cfg.default_adapter(device)
    elif isinstance(model, str):
        lm_kwargs: Dict[str, Any] = {"device": device}
        if data is not None and hasattr(data[0], "vocab_size"):
            lm_kwargs["vocab_size"] = data[0].vocab_size
        adapter = make_adapter(model, **lm_kwargs)
    else:
        adapter = make_adapter(model)
    if (isinstance(adapter, LMAdapter) and data is not None
            and getattr(data[0], "vocab_size", 0) > adapter.arch.vocab_size):
        raise ValueError(
            f"data vocab_size {data[0].vocab_size} exceeds the adapter's "
            f"{adapter.arch.vocab_size} — token ids would clamp silently")

    max_rounds = rounds if rounds is not None else (
        task.max_rounds if task is not None else 10)
    if task is None:
        task = _default_task(max_rounds)

    # 1-2. publication + incentive negotiation
    rng = np.random.default_rng(seed)
    node_ids = list(range(n_nodes))
    if gamma is None:
        gamma = {i: float(g)
                 for i, g in enumerate(rng.uniform(0.008, 0.02, n_nodes))}
    if mu is None:
        mu = {i: 5.0 for i in node_ids}
    agreement = negotiate_task(task, node_ids, gamma, mu)
    rewards = RewardLedger(agreement)

    # 3. hierarchy over (possibly synthesized) data
    if data is None:
        if sc is not None and isinstance(adapter, MLPAdapter):
            # scenario sizing: protocol behaviour under faults is the
            # object of study, so the workload stays small
            data = make_mnist_like(n_train=sc.n_train, n_test=sc.n_test,
                                   seed=seed)
        else:
            data = _default_data(adapter, seed)
    train, test = data
    if distribution != "iid" and not hasattr(train, "n_classes"):
        raise ValueError(
            f"distribution={distribution!r} needs labelled image data "
            f"(.y/.n_classes); {type(train).__name__} workloads support "
            f"'iid' only")
    clusters = build_hierarchy(train, n_nodes, cfg.clients_per_node,
                               distribution, seed=seed)

    # 4a. sharded consortium: K committee-scoped PoFEL instances with
    # cross-shard checkpoint sync (repro_torch.fl.consortium). committees=1
    # (explicit or default) stays on the single-committee path below.
    k_committees = committees if committees is not None else (
        sc.committees if sc is not None else 1)
    if k_committees is not None and k_committees > 1:
        if faults is not None:
            raise ValueError(
                "faults= is unsupported with committees > 1; shape the "
                "consortium via a Scenario (net / cross_net / adversaries)")
        from repro_torch.fl.consortium import ConsortiumRuntime
        from repro_torch.sim import Scenario as _Scenario
        csc = sc
        if csc is None:
            csc = _Scenario(
                name=f"consortium_k{k_committees}",
                description="ad-hoc consortium run (api.run_bhfl)",
                rounds=max_rounds, n_nodes=cfg.n_nodes,
                clients_per_node=cfg.clients_per_node)
        if (csc.committees != k_committees
                or (checkpoint_interval is not None
                    and csc.checkpoint_interval != checkpoint_interval)):
            csc = dataclasses.replace(
                csc, committees=k_committees,
                committee_sizes=(csc.committee_sizes
                                 if csc.committees == k_committees
                                 else None),
                checkpoint_interval=(checkpoint_interval
                                     if checkpoint_interval is not None
                                     else csc.checkpoint_interval))
        consortium = ConsortiumRuntime(clusters, cfg, test, adapter=adapter,
                                       scenario=csc, seed=seed,
                                       device=device)
        if vote_hook is not None:
            consortium.set_vote_hook(vote_hook)
        if plagiarists:
            consortium.set_plagiarists(plagiarists)
        run = BHFLRun(task, agreement, rewards, consortium,
                      consortium.history)
        for _ in range(min(max_rounds, task.max_rounds)):
            round_metrics = consortium.run_round()
            for gid in consortium.last_leaders:
                rewards.settle_round(gid)
            if on_round is not None:
                for m in round_metrics:
                    on_round(m)
            losses = [m.test_loss for m in round_metrics
                      if not np.isnan(m.test_loss)]
            if test is not None and losses \
                    and max(losses) <= task.target_loss:
                break
        run.scenario_report = consortium.finalize(
            csc.name, seed, rounds_requested=consortium.rounds_run)
        rec = get_recorder()
        if rec.enabled:
            run.obs = rec.metrics_snapshot()
        return run

    # 4b. FEL + consensus rounds until termination (single committee)
    runtime = BHFLRuntime(clusters, cfg, test, adapter=adapter, device=device)
    runtime.vote_hook = vote_hook
    runtime.plagiarists = set(plagiarists)
    env = faults
    if sc is not None:
        from repro_torch.sim import build_env
        env = build_env(sc, n_nodes=cfg.n_nodes, seed=seed)
    if env is not None:
        if env.network.n_nodes != cfg.n_nodes:
            raise ValueError(
                f"faults/scenario env simulates {env.network.n_nodes} "
                f"nodes but the run has n_nodes={cfg.n_nodes}")
        runtime.env = env
        env.bind(runtime.consensus)
        runtime.plagiarists |= env.plagiarist_ids()
    run = BHFLRun(task, agreement, rewards, runtime, runtime.history)
    for _ in range(min(max_rounds, task.max_rounds)):
        m = runtime.run_round()
        if m.leader_id >= 0:    # aborted rounds reward no leader
            rewards.settle_round(m.leader_id)
        if on_round is not None:
            on_round(m)
        if test is not None and m.test_loss <= task.target_loss:
            break
    if env is not None:
        run.scenario_report = env.finalize(
            scenario=sc.name if sc is not None else "custom",
            seed=seed, rounds_requested=len(runtime.history))
    rec = get_recorder()
    if rec.enabled:
        run.obs = rec.metrics_snapshot()
    return run
