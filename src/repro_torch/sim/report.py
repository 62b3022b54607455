"""Typed scenario reports: what a fault-injection run actually proves.

A :class:`ScenarioReport` condenses a simulated BHFL run into the claims
the paper makes in §3.2/§7.4 — liveness (every round minted a block),
safety (no two honest nodes ever held conflicting blocks at the same
height), honest leadership under attack, and how long honest ledgers
stayed diverged before catch-up sync reconverged them.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.blockchain.block import block_hash
from repro_torch.obs import get_recorder


@dataclass
class RoundReport:
    """One consensus round as observed by the simulator."""

    round: int
    leader: int                       # -1 when the round aborted
    aborted: bool
    reelections: int
    honest_leader: Optional[bool]     # None when aborted
    # did the elected leader match the honest similarity argmax? (the §7.4
    # bribery-defeat claim; False is legitimate after a re-election)
    leader_is_argmax: Optional[bool]
    available: Optional[List[int]]    # models that reached reveal quorum
    rejected: Dict[int, str]
    heights: Dict[int, int]           # honest node -> chain height
    heads: Dict[int, str]             # honest node -> head hash
    diverged: bool                    # honest ledgers disagree at round end
    test_accuracy: float
    test_loss: float
    # which committee observed this round (0 in single-committee runs; a
    # sharded consortium merges every committee's rounds into one report,
    # with node ids remapped to their global identities)
    committee: int = 0


@dataclass
class CommitteeReport:
    """Per-committee rollup inside a sharded-consortium scenario report:
    one row per PoFEL instance, with node ids in *global* terms."""

    committee_id: int
    members: List[int]                # global node ids
    rounds_requested: int
    completed_rounds: int
    aborted_rounds: int
    liveness: bool
    safety_violations: int            # on this committee's subchain
    reelections: int
    recoveries: int
    checkpoints_emitted: int          # checkpoint blocks this committee minted
    checkpoints_merged: int           # peer checkpoints adopted cross-shard
    converged: bool                   # honest subchain convergence
    final_height: int
    final_head: str


@dataclass
class ScenarioReport:
    """The scenario-level verdict (one JSON object per run in CI)."""

    scenario: str
    seed: int
    n_nodes: int
    quorum: int
    adversary_ids: List[int]
    rounds_requested: int
    completed_rounds: int
    aborted_rounds: int
    liveness: bool                    # every requested round minted a block
    safety_violations: int            # conflicting honest blocks per height
    honest_leader_rate: float         # completed rounds led by honest nodes
    argmax_leader_rate: float         # leaders matching the honest ME argmax
    reelections: int                  # leader timeouts recovered from
    rounds_to_recover: int            # rounds honest ledgers spent diverged
    converged: bool                   # all honest chains identical at end
    final_heights: Dict[int, int]
    final_heads: Dict[int, str]
    # envelopes the batch signature verification rejected, with attribution
    # (the message-layer forgery count — see repro_torch.core.envelope)
    rejected_envelopes: int = 0
    # reliability layer (RetrySpec retransmission + gossip — see
    # repro_torch.sim.network) and crash recovery (repro_torch.core.recovery)
    retransmits: int = 0              # resends after a stochastic drop
    recovered_deliveries: int = 0     # deliveries that needed a retransmit
    gossip_deliveries: int = 0        # deliveries made by anti-entropy
    recoveries: int = 0               # WAL restarts + ledger-resync rejoins
    equivocations_detected: int = 0   # attributed cross-restart double-signs
    plagiarism_evictions: int = 0     # HCDS tie-break evictions, attributed
    # sharded consortium (repro_torch.fl.consortium): K > 1 committee-scoped
    # PoFEL instances merged into one report. All default-empty so a
    # single-committee report (and its summary()) is byte-identical to
    # the pre-shard format.
    committees: int = 1
    committee_reports: List[CommitteeReport] = field(default_factory=list)
    cross_shard_checkpoints: int = 0  # peer checkpoints merged, all shards
    top_chain_height: int = 0         # tallest top-chain after final sync
    top_chain_converged: bool = True  # all committee top-chains agree
    rounds: List[RoundReport] = field(default_factory=list)
    events: List[Dict[str, Any]] = field(default_factory=list)
    net_stats: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # metrics rollup from the active obs recorder (empty when tracing off)
    obs_metrics: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=str)

    def summary(self) -> str:
        base = (f"{self.scenario}: {self.completed_rounds}/"
                f"{self.rounds_requested} rounds, "
                f"liveness={'ok' if self.liveness else 'VIOLATED'}, "
                f"safety_violations={self.safety_violations}, "
                f"honest_leader_rate={self.honest_leader_rate:.2f}, "
                f"reelections={self.reelections}, "
                f"rejected_envelopes={self.rejected_envelopes}, "
                f"retransmits={self.retransmits}, "
                f"recoveries={self.recoveries}, "
                f"equivocations={self.equivocations_detected}, "
                f"rounds_to_recover={self.rounds_to_recover}, "
                f"converged={self.converged}")
        if not self.committee_reports:
            # single-committee: exactly the pre-shard one-line summary
            return base
        lines = [base]
        for c in self.committee_reports:
            lines.append(
                f"  committee {c.committee_id} (n={len(c.members)}): "
                f"{c.completed_rounds}/{c.rounds_requested} rounds, "
                f"liveness={'ok' if c.liveness else 'VIOLATED'}, "
                f"reelections={c.reelections}, "
                f"checkpoints_emitted={c.checkpoints_emitted}, "
                f"cross_shard_merged={c.checkpoints_merged}, "
                f"converged={c.converged}")
        lines.append(
            f"  top-chain: height={self.top_chain_height}, "
            f"cross_shard_checkpoints={self.cross_shard_checkpoints}, "
            f"converged={self.top_chain_converged}")
        return "\n".join(lines)


def _honest_ledger_state(env) -> Dict[int, Any]:
    ledgers = env._consensus.ledgers if env._consensus is not None else []
    return {led.node_id: led for led in ledgers
            if led.node_id in set(env.honest_ids())}


def snapshot_round(env, k: int, metrics: Any, aborted: bool) -> RoundReport:
    """Freeze one round's observable state (called from SimEnv.end_round)."""
    honest = _honest_ledger_state(env)
    # record what every honest node holds NOW, before a later round's
    # fork-choice or the final catch-up sync can rewrite a diverged chain
    # — safety violations are judged against this accumulated evidence
    for led in honest.values():
        for h, b in enumerate(led.blocks):
            env.height_hashes.setdefault(h, set()).add(block_hash(b))
    heights = {i: led.height for i, led in honest.items()}
    heads = {i: led.head_hash for i, led in honest.items()}
    diverged = len({(heights[i], heads[i]) for i in honest}) > 1
    record = getattr(metrics, "consensus", None)
    reelections, available, rejected, is_argmax = 0, None, {}, None
    if record is not None and record.block is not None:
        reelections = int(record.block.extra.get("reelections", 0))
        available = record.block.extra.get("available")
        rejected = dict(record.rejected)
        sims = np.asarray(record.similarities, np.float64)
        masked = np.full_like(sims, -np.inf)
        avail = available if available is not None else range(len(sims))
        masked[list(avail)] = sims[list(avail)]
        is_argmax = bool(int(np.argmax(masked)) == record.leader_id)
    leader = int(getattr(metrics, "leader_id", -1))
    return RoundReport(
        round=k,
        leader=leader,
        aborted=aborted,
        reelections=reelections,
        honest_leader=None if aborted else leader not in env.adversary_ids,
        leader_is_argmax=is_argmax,
        available=available,
        rejected=rejected,
        heights=heights,
        heads=heads,
        diverged=diverged,
        test_accuracy=float(getattr(metrics, "test_accuracy", float("nan"))),
        test_loss=float(getattr(metrics, "test_loss", float("nan"))),
    )


def count_safety_violations(env) -> int:
    """Heights at which two honest nodes ever committed conflicting blocks.

    This is the §3.2 safety claim, checked rather than assumed. The
    per-round snapshots accumulated every block hash honest nodes held at
    each height *before* fork-choice or the final sync could overwrite a
    diverged chain; the final ledgers are folded in as one last snapshot.
    A height with more than one distinct hash in that history is a
    violation even if the chains have since reconverged."""
    history = {h: set(s) for h, s in env.height_hashes.items()}
    for led in _honest_ledger_state(env).values():
        for h, b in enumerate(led.blocks):
            history.setdefault(h, set()).add(block_hash(b))
    return sum(1 for s in history.values() if len(s) > 1)


def build_report(env, scenario: str, seed: int,
                 rounds_requested: int) -> ScenarioReport:
    """Assemble the scenario verdict after the final catch-up sync."""
    logs = list(env.round_logs)
    completed = [r for r in logs if not r.aborted]
    honest = _honest_ledger_state(env)
    final_heights = {i: led.height for i, led in honest.items()}
    final_heads = {i: led.head_hash for i, led in honest.items()}
    converged = len({(final_heights[i], final_heads[i])
                     for i in honest}) <= 1
    honest_led = [r for r in completed if r.honest_leader]
    return ScenarioReport(
        scenario=scenario,
        seed=seed,
        n_nodes=env.network.n_nodes,
        quorum=env.quorum,
        adversary_ids=sorted(env.adversary_ids),
        rounds_requested=rounds_requested,
        completed_rounds=len(completed),
        aborted_rounds=len(logs) - len(completed),
        liveness=(len(completed) == rounds_requested),
        safety_violations=count_safety_violations(env),
        honest_leader_rate=(len(honest_led) / len(completed)
                            if completed else 0.0),
        argmax_leader_rate=(sum(1 for r in completed if r.leader_is_argmax)
                            / len(completed) if completed else 0.0),
        reelections=sum(r.reelections for r in logs),
        rounds_to_recover=sum(1 for r in logs if r.diverged),
        converged=converged,
        final_heights=final_heights,
        final_heads=final_heads,
        rejected_envelopes=sum(1 for e in env.events
                               if e.get("event") == "envelope_rejected"),
        retransmits=sum(s.get("retransmits", 0)
                        for s in env.network.stats.values()),
        recovered_deliveries=sum(s.get("recovered", 0)
                                 for s in env.network.stats.values()),
        gossip_deliveries=sum(s.get("gossip", 0)
                              for s in env.network.stats.values()),
        recoveries=int(getattr(env, "recoveries", 0)),
        equivocations_detected=sum(
            1 for e in env.events
            if e.get("event") == "equivocation_detected"),
        plagiarism_evictions=sum(
            1 for e in env.events
            if e.get("event") == "plagiarism_evicted"),
        rounds=logs,
        events=list(env.events),
        net_stats={k: dict(v) for k, v in env.network.stats.items()},
        obs_metrics=get_recorder().metrics_snapshot(),
    )


# ---------------------------------------------------------------------------
# Sharded consortium: merge per-committee reports into one verdict
# ---------------------------------------------------------------------------

def _globalize_round(r: RoundReport, com: Any) -> RoundReport:
    """A committee's round report with every node id remapped to its
    global identity (leader, availability set, rejections, ledger maps)."""
    from dataclasses import replace
    gid = com.global_id
    return replace(
        r,
        leader=gid(r.leader) if r.leader >= 0 else -1,
        available=(None if r.available is None
                   else [gid(i) for i in r.available]),
        rejected={gid(i): reason for i, reason in r.rejected.items()},
        heights={gid(i): h for i, h in r.heights.items()},
        heads={gid(i): h for i, h in r.heads.items()},
        committee=com.committee_id,
    )


def merge_consortium_report(
        scenario: str, seed: int, committees: List[Any],
        sub_reports: List[ScenarioReport], *,
        rounds_requested: int,
        checkpoints_emitted: List[int],
        checkpoints_merged: List[int],
        top_heights: Dict[int, int],
        top_heads: Dict[int, str],
        top_safety_violations: int,
        cross_stats: Dict[str, Dict[str, int]]) -> ScenarioReport:
    """Fold K per-committee :class:`ScenarioReport` objects (one per
    PoFEL shard, produced by each shard env's ``finalize``) plus the
    cross-shard checkpoint layer into one consortium verdict.

    Semantics of the merged headline numbers:

    * ``liveness`` — every committee completed every requested round;
      ``completed_rounds`` is the min across committees (rounds the whole
      consortium finished), ``aborted_rounds`` the total liveness gaps.
    * ``safety_violations`` — the sum of per-subchain violations plus
      heights where the committees' *top-chains* still disagree after the
      final sync. Concurrent checkpoints under a healed cross-shard
      partition are fork-choice fodder, not violations.
    * rate fields are weighted by each committee's completed rounds.
    * node-keyed maps (``final_heights``/``final_heads``, round rows) are
      remapped to global node ids, so consumers see one namespace.
    """
    k = len(committees)
    if not (k == len(sub_reports) == len(checkpoints_emitted)
            == len(checkpoints_merged)):
        raise ValueError("merge_consortium_report: per-committee inputs "
                         "must align with the committee list")
    completed = [r.completed_rounds for r in sub_reports]
    weights = [max(c, 0) for c in completed]
    total_w = sum(weights)

    def wmean(values: List[float]) -> float:
        if total_w == 0:
            return 0.0
        return sum(v * w for v, w in zip(values, weights)) / total_w

    rounds: List[RoundReport] = []
    events: List[Dict[str, Any]] = []
    final_heights: Dict[int, int] = {}
    final_heads: Dict[int, str] = {}
    net_stats: Dict[str, Dict[str, int]] = {}
    committee_rows: List[CommitteeReport] = []
    adversary_ids: List[int] = []
    for com, sub, emitted, merged in zip(committees, sub_reports,
                                         checkpoints_emitted,
                                         checkpoints_merged):
        rounds.extend(_globalize_round(r, com) for r in sub.rounds)
        for e in sub.events:
            events.append({**e, "committee": com.committee_id})
        adversary_ids.extend(com.global_id(i) for i in sub.adversary_ids)
        final_heights.update({com.global_id(i): h
                              for i, h in sub.final_heights.items()})
        final_heads.update({com.global_id(i): h
                            for i, h in sub.final_heads.items()})
        for kind, stats in sub.net_stats.items():
            net_stats[f"c{com.committee_id}:{kind}"] = dict(stats)
        committee_rows.append(CommitteeReport(
            committee_id=com.committee_id,
            members=list(com.members),
            rounds_requested=sub.rounds_requested,
            completed_rounds=sub.completed_rounds,
            aborted_rounds=sub.aborted_rounds,
            liveness=sub.liveness,
            safety_violations=sub.safety_violations,
            reelections=sub.reelections,
            recoveries=sub.recoveries,
            checkpoints_emitted=emitted,
            checkpoints_merged=merged,
            converged=sub.converged,
            final_height=max(sub.final_heights.values(), default=0),
            final_head=sub.final_heads[max(
                sub.final_heights, key=lambda i: (sub.final_heights[i], -i))]
            if sub.final_heads else "",
        ))
    for kind, stats in cross_stats.items():
        net_stats[f"xshard:{kind}"] = dict(stats)
    rounds.sort(key=lambda r: (r.round, r.committee))
    cross_retransmits = sum(s.get("retransmits", 0)
                            for s in cross_stats.values())
    cross_recovered = sum(s.get("recovered", 0)
                          for s in cross_stats.values())
    cross_gossip = sum(s.get("gossip", 0) for s in cross_stats.values())
    # all committee top-chains must agree (height AND head) after the
    # final sync — lingering disagreement is a cross-shard safety breach
    top_converged = len({(top_heights[c], top_heads[c])
                         for c in sorted(top_heights)}) <= 1
    return ScenarioReport(
        scenario=scenario,
        seed=seed,
        n_nodes=sum(c.size for c in committees),
        quorum=committees[0].quorum,
        adversary_ids=sorted(adversary_ids),
        rounds_requested=rounds_requested,
        completed_rounds=min(completed) if completed else 0,
        aborted_rounds=sum(r.aborted_rounds for r in sub_reports),
        liveness=all(r.liveness for r in sub_reports),
        safety_violations=(sum(r.safety_violations for r in sub_reports)
                           + top_safety_violations),
        honest_leader_rate=wmean([r.honest_leader_rate
                                  for r in sub_reports]),
        argmax_leader_rate=wmean([r.argmax_leader_rate
                                  for r in sub_reports]),
        reelections=sum(r.reelections for r in sub_reports),
        rounds_to_recover=sum(r.rounds_to_recover for r in sub_reports),
        converged=(all(r.converged for r in sub_reports) and top_converged),
        final_heights=final_heights,
        final_heads=final_heads,
        rejected_envelopes=sum(r.rejected_envelopes for r in sub_reports),
        retransmits=sum(r.retransmits
                        for r in sub_reports) + cross_retransmits,
        recovered_deliveries=sum(r.recovered_deliveries
                                 for r in sub_reports) + cross_recovered,
        gossip_deliveries=sum(r.gossip_deliveries
                              for r in sub_reports) + cross_gossip,
        recoveries=sum(r.recoveries for r in sub_reports),
        equivocations_detected=sum(r.equivocations_detected
                                   for r in sub_reports),
        plagiarism_evictions=sum(r.plagiarism_evictions
                                 for r in sub_reports),
        committees=k,
        committee_reports=committee_rows,
        cross_shard_checkpoints=sum(checkpoints_merged),
        top_chain_height=max(top_heights.values(), default=0),
        top_chain_converged=top_converged,
        rounds=rounds,
        events=events,
        net_stats=net_stats,
        obs_metrics=get_recorder().metrics_snapshot(),
    )
