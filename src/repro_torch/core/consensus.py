"""PoFEL — Proof of Federated Edge Learning consensus (paper §4, Alg. 1).

One consensus round among N BCFL nodes, given their FEL models W(k):

  1. HCDS(w^i(k)) at every e_i            — commit/reveal model exchange
  2. (e_best^i, P^i, gw) = ME(W(k))        — aggregate + similarity + vote
  3. submit votes to the vote-tally smart contract
  4. e*(k) = BTSV(E_best(k), P(k))         — weighted tally, leader election
  5. leader mints + signs the new block; every node verifies and appends

``PoFELConsensus`` is the host-side orchestrator used by the paper-faithful
FL runtime and the benchmarks. It composes the five protocol phases from
``repro_torch.core.phases`` (CommitReveal → ModelEvaluation → VoteCollection →
Tally → BlockMint) over a typed ``RoundContext``; swap or hook individual
phases instead of overriding ``run_round``. The in-graph sharded ME used
by the large-model training path lives in ``repro_torch.fl.sharded_consensus``
(a drop-in replacement for the ``ModelEvaluation`` phase).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.blockchain.block import Block
from repro_torch.blockchain.ledger import Ledger
from repro_torch.blockchain.smart_contract import VoteTallyContract
from repro_torch.core.btsv import BTSVConfig, BTSVResult
from repro_torch.core.hcds import HCDSNode
from repro_torch.core.phases import (BlockMint, CommitReveal, ConsensusPhase,
                                     ModelEvaluation, PhaseHook, RoundContext,
                                     Tally, VoteCollection, VoteHook,
                                     run_phases)
from repro_torch.core.recovery import NodeWAL
from repro_torch.obs import get_recorder, phase_span_after, phase_span_before
from repro_torch.obs import sim_now as _sim_now


@dataclass
class ConsensusRecord:
    round: int
    leader_id: int
    similarities: np.ndarray
    votes: np.ndarray
    btsv: BTSVResult
    block: Block
    global_model: Any            # gw(k) as a flat array
    rejected: Dict[int, str]     # node_id -> rejection reason (HCDS failures)


class PoFELConsensus:
    """Full-system consensus driver over N co-simulated BCFL nodes.

    The protocol pipeline is ``self.phases`` — a list of
    :class:`~repro_torch.core.phases.ConsensusPhase` objects executed in order
    over a shared :class:`~repro_torch.core.phases.RoundContext`. Experiments
    customize behaviour three ways, from least to most invasive:

    * ``vote_hook=`` on :meth:`run_round` — per-node vote manipulation;
    * :meth:`add_phase_hook` — observe/tamper context before/after a phase;
    * :meth:`replace_phase` — swap an implementation (e.g. the sharded
      in-graph ME from ``repro_torch.fl.sharded_consensus``).
    """

    # re-exported for back-compat with pre-phase callers
    VoteHook = VoteHook

    def __init__(self, n_nodes: int, btsv_cfg: Optional[BTSVConfig] = None,
                 g_max: float = 0.99, nonce_len: int = 32,
                 committee: Optional[Any] = None):
        # None-default instead of a module-level BTSVConfig() instance in
        # the signature (BTSVConfig is an immutable NamedTuple, so sharing
        # was harmless — this is signature hygiene, not a state fix)
        btsv_cfg = BTSVConfig() if btsv_cfg is None else btsv_cfg
        self.n_nodes = n_nodes
        self.btsv_cfg = btsv_cfg
        self.g_max = g_max
        # committee scope (repro_torch.core.committee.Committee): when
        # set, this instance is one shard of a consortium — node ids
        # 0..n-1 here are committee-LOCAL, and signing keys derive from the
        # members' GLOBAL ids so no two committees share a key and the
        # consortium key directory is global-id-keyed. None keeps the
        # classic single global committee.
        if committee is not None and committee.size != n_nodes:
            raise ValueError(
                f"committee {committee.committee_id} has {committee.size} "
                f"members but consensus was sized for {n_nodes} nodes")
        self.committee = committee
        # one durable protocol WAL per node: commits/reveals/votes/blocks
        # are logged before signing, so a node restarted through the
        # recovery path (repro_torch.core.recovery) replays instead of
        # re-signing, and a conflicting statement for an already-logged
        # round raises WALConflict — the double-sign protection §4.1
        # assumes. (A simulated amnesia fault detaches its node's WAL.)
        self.wals: Dict[int, NodeWAL] = {i: NodeWAL(i)
                                         for i in range(n_nodes)}
        if committee is None:
            keypairs = {i: None for i in range(n_nodes)}
        else:
            from repro_torch.core.committee import committee_keypair
            keypairs = {i: committee_keypair(committee.committee_id,
                                             committee.global_id(i))
                        for i in range(n_nodes)}
        self.hcds_nodes = [HCDSNode(i, keypair=keypairs[i],
                                    nonce_len=nonce_len, wal=self.wals[i])
                           for i in range(n_nodes)]
        self.public_keys = {n.node_id: n.keypair.public_key for n in self.hcds_nodes}
        # the contract knows the consortium's keys, so vote envelopes are
        # batch-verified (and forgeries attributed) at tally time; every
        # node has a signer here, so unsigned votes are not a legitimate
        # path either — a spoofed submission without an envelope must not
        # count just because it skipped signing
        self.contract = VoteTallyContract(n_nodes, btsv_cfg,
                                          public_keys=self.public_keys,
                                          require_signatures=True)
        self.ledgers = [Ledger(i) for i in range(n_nodes)]
        self.round = 0
        self.phases: List[ConsensusPhase] = self.default_phases()
        self._before_hooks: Dict[str, List[PhaseHook]] = {}
        self._after_hooks: Dict[str, List[PhaseHook]] = {}
        # span tracing rides the public hook seam like any other observer;
        # "*" hooks run after named ones on both sides, so the before-span
        # opens just ahead of phase.run and the after-span closes last —
        # named user hooks execute inside the phase span
        self.add_phase_hook("*", phase_span_before, when="before")
        self.add_phase_hook("*", phase_span_after, when="after")

    def default_phases(self) -> List[ConsensusPhase]:
        """Alg. 1 as five composable stages."""
        return [
            CommitReveal(self.hcds_nodes, self.public_keys),
            ModelEvaluation(),
            VoteCollection(self.contract,
                           signers={n.node_id: n.keypair
                                    for n in self.hcds_nodes},
                           wals=self.wals),
            Tally(self.contract),
            BlockMint(self.ledgers, self.hcds_nodes, self.public_keys,
                      self.contract, wals=self.wals),
        ]

    # -- phase plumbing ------------------------------------------------------
    def add_phase_hook(self, phase: str, fn: PhaseHook,
                       when: str = "after") -> None:
        """Register ``fn(phase_name, ctx)`` before/after phase ``phase``
        (``"*"`` fires around every phase)."""
        if when not in ("before", "after"):
            raise ValueError(f"when must be 'before' or 'after', got {when!r}")
        hooks = self._before_hooks if when == "before" else self._after_hooks
        hooks.setdefault(phase, []).append(fn)

    def replace_phase(self, name: str, phase: ConsensusPhase) -> None:
        """Swap the pipeline stage whose ``name`` matches (e.g. replace
        ``model_evaluation`` with the sharded in-graph variant)."""
        for i, p in enumerate(self.phases):
            if p.name == name:
                self.phases[i] = phase
                return
        raise KeyError(f"no phase named {name!r} in pipeline "
                       f"{[p.name for p in self.phases]}")

    def get_phase(self, name: str) -> ConsensusPhase:
        for p in self.phases:
            if p.name == name:
                return p
        raise KeyError(f"no phase named {name!r}")

    # -- one round -----------------------------------------------------------
    def run_round(self, models: Sequence[Any], data_sizes: Sequence[float],
                  vote_hook: Optional[VoteHook] = None,
                  env: Optional[Any] = None,
                  ) -> ConsensusRecord:
        """Alg. 1 for one round k; ``models`` is the list of FEL pytrees.

        ``env`` (a ``repro_torch.sim.network.SimEnv``) switches every phase into
        networked mode: messages travel a fault-injected bus, quorums and
        timeouts apply, and the round may raise
        :class:`~repro_torch.core.phases.QuorumNotReached` — callers then record
        the liveness gap and :meth:`skip_round`.
        """
        ctx = RoundContext(
            round=self.round,
            models=list(models),
            data_sizes=[float(s) for s in data_sizes],
            n_nodes=self.n_nodes,
            g_max=self.g_max,
            vote_hook=vote_hook,
            env=env,
            committee=self.committee,
        )
        rec = get_recorder()
        # committee-scoped runs tag their spans so the profiler can drill
        # per-committee critical paths; the unsharded path stays untagged
        # (and therefore byte-identical in every trace artifact)
        com_attrs = ({} if self.committee is None
                     else {"committee": self.committee.committee_id})
        rec.open_span("consensus", cat="consensus", round=ctx.round,
                      sim_now=_sim_now(env), **com_attrs)
        depth = rec.depth()
        try:
            run_phases(self.phases, ctx,
                       before=self._before_hooks, after=self._after_hooks)
        except Exception as exc:
            # after-hooks never fire for a raising phase, so its span (and
            # the consensus span) would stay open — close them with the
            # error attached so aborted rounds still appear in the trace
            rec.unwind(depth, error=type(exc).__name__)
            rec.close_span(sim_now=_sim_now(env),
                           error=type(exc).__name__)
            raise
        rec.close_span(sim_now=_sim_now(env))
        self.round += 1
        # gw(k) stays whatever ME produced (a tensor on the models'
        # device) — adopting it must not force a host roundtrip; callers
        # that need numpy copy it to the host themselves
        gw = (ctx.evaluation.global_model if ctx.evaluation is not None
              else None)
        return ConsensusRecord(ctx.round, ctx.leader, ctx.similarities,
                               ctx.votes, ctx.btsv, ctx.block,
                               gw, ctx.rejected)

    def skip_round(self) -> None:
        """Advance past a round that failed to reach quorum: discard its
        partial contract submissions and move the round counter so the
        next attempt starts clean (the ledgers simply have no block for
        the skipped round — a recorded liveness gap, not a fork)."""
        self.contract.drop_round(self.round)
        self.round += 1

    @property
    def chain(self) -> List[Block]:
        return self.ledgers[0].blocks
