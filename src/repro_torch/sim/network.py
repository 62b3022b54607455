"""Deterministic discrete-event message bus for BHFL consensus rounds.

The paper evaluates PoFEL in an ideal world — every node present,
synchronous, lossless. This module supplies the non-ideal one: a seeded
discrete-event network (per-link latency distributions, drop rates,
partitions, node churn) plus :class:`SimEnv`, the object the consensus
phases consult when running in networked mode (``RoundContext.env``).

Everything is driven by one ``numpy`` Generator seeded at construction,
so a scenario replays bit-identically for a given seed: same latencies,
same drops, same adversarial random votes, same report.

Time is simulated (milliseconds of virtual time, no wall-clock): each
protocol phase (commit / reveal / vote / block) broadcasts its messages
onto a priority queue and then advances the clock to the phase deadline;
messages scheduled past the deadline are timeouts, indistinguishable
from drops to the receiver — which is exactly the point.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.obs import get_recorder

DEFAULT_TIMEOUTS: Mapping[str, float] = {
    "commit": 60.0, "reveal": 60.0, "vote": 60.0, "block": 90.0,
    "checkpoint": 90.0}


@dataclass(frozen=True)
class LinkSpec:
    """Per-link delivery model: latency = base + Exp(jitter), iid per
    message; ``drop_rate`` is the independent per-message loss probability."""

    base_latency: float = 5.0     # ms
    jitter: float = 2.0           # exponential jitter scale (ms)
    drop_rate: float = 0.0


@dataclass(frozen=True)
class PartitionSpec:
    """Network split into ``groups`` for rounds [start_round, end_round):
    messages cross group boundaries only after the partition heals."""

    groups: Tuple[Tuple[int, ...], ...]
    start_round: int
    end_round: int

    def __post_init__(self) -> None:
        if self.start_round >= self.end_round:
            raise ValueError(
                f"partition window [{self.start_round}, {self.end_round}) is "
                f"empty: start_round must be < end_round")


@dataclass(frozen=True)
class ChurnSpec:
    """Node ``node`` is down (crashed) for rounds [down_from, down_until):
    it neither sends nor receives, and skips FEL training entirely."""

    node: int
    down_from: int
    down_until: int = 1 << 30

    def __post_init__(self) -> None:
        if self.down_from >= self.down_until:
            raise ValueError(
                f"churn window [{self.down_from}, {self.down_until}) for "
                f"node {self.node} is empty: down_from must be < down_until")


@dataclass(frozen=True)
class RetrySpec:
    """Reliable-delivery policy for :meth:`SimNetwork.exchange`.

    With ``max_retries == 0`` (the default) the bus is the original
    one-shot broadcast: a dropped message is lost for the phase. With
    retries, a sender whose copy was dropped retransmits after an
    exponential backoff — ``base_backoff * backoff_factor**attempt``,
    capped at ``max_backoff`` — as long as the resend still fits inside
    the phase deadline. ``gossip`` adds one pull-based anti-entropy pass
    per exchange: receivers that got a payload forward it to live peers
    that missed every direct copy (one forwarding attempt per missing
    pair, subject to the same link loss), which is how reveal quorums
    survive drop rates that defeat even the retransmitting sender."""

    max_retries: int = 0
    base_backoff: float = 4.0     # ms before the first retransmission
    backoff_factor: float = 2.0
    max_backoff: float = 40.0     # ms cap on a single backoff step
    gossip: bool = False

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.base_backoff < 0 or self.max_backoff < 0:
            raise ValueError("backoff delays must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1 (non-shrinking schedule), "
                f"got {self.backoff_factor}")

    def backoff(self, attempt: int) -> float:
        """Wait before retransmission number ``attempt + 1`` (ms)."""
        return min(self.base_backoff * self.backoff_factor ** attempt,
                   self.max_backoff)

    def schedule(self, deadline_ms: float) -> List[float]:
        """Send offsets (ms from phase start) of every attempt that fits
        the deadline — attempt 0 at t=0, then each retransmission after
        its backoff. Bounded by ``max_retries`` and the deadline."""
        offsets, t = [0.0], 0.0
        for attempt in range(self.max_retries):
            t += self.backoff(attempt)
            if t > deadline_ms:
                break
            offsets.append(t)
        return offsets


@dataclass(frozen=True)
class NetworkConfig:
    link: LinkSpec = LinkSpec()
    partitions: Tuple[PartitionSpec, ...] = ()
    churn: Tuple[ChurnSpec, ...] = ()
    timeouts: Mapping[str, float] = field(
        default_factory=lambda: dict(DEFAULT_TIMEOUTS))
    retry: RetrySpec = RetrySpec()


class SimNetwork:
    """The bus. One instance simulates all N×N links of a BHFL deployment."""

    def __init__(self, n_nodes: int, config: Optional[NetworkConfig] = None,
                 seed: int = 0, committee: Optional[int] = None):
        self.n_nodes = n_nodes
        self.config = config or NetworkConfig()
        # committee-scoped buses (one per shard of a consortium) label
        # their spans/events so intra- vs cross-shard traffic can be told
        # apart in the trace; None (the unsharded bus) adds no attrs, so
        # single-committee event logs stay byte-identical
        self.committee = committee
        self._tag: Dict[str, Any] = (
            {} if committee is None else {"committee": committee})
        self.rng = np.random.default_rng(seed)
        self.now = 0.0
        self.round = 0
        self._seq = 0                 # heapq tie-break
        # mid-phase crash faults: node -> first round it is back up
        # (distinct from config.churn, which is scheduled at construction —
        # these are imposed at runtime by SimEnv.execute_crash)
        self.downed: Dict[int, int] = {}
        self.stats: Dict[str, Dict[str, int]] = {}
        # senders of the most recent exchange, ordered by earliest
        # network-wide delivery — the bus's stand-in for the permissioned
        # chain's transaction-inclusion order (consumed by the commit
        # phase to fix commitment precedence; see phases.CommitReveal)
        self.last_order: List[int] = []
        for spec in self.config.churn:
            if not (0 <= spec.node < n_nodes):
                raise ValueError(f"churn names unknown node {spec.node}")
        for spec in self.config.partitions:
            named = [i for g in spec.groups for i in g]
            if sorted(named) != list(range(n_nodes)):
                raise ValueError(
                    f"partition groups {spec.groups} must cover every node "
                    f"of 0..{n_nodes - 1} exactly once")

    # -- topology state ------------------------------------------------------
    def set_round(self, k: int) -> None:
        self.round = k

    def alive(self) -> Set[int]:
        down = {c.node for c in self.config.churn
                if c.down_from <= self.round < c.down_until}
        down |= {n for n, up_round in self.downed.items()
                 if self.round < up_round}
        return set(range(self.n_nodes)) - down

    def force_down(self, node: int, until_round: int) -> None:
        """Crash ``node`` now; it is down until the start of round
        ``until_round`` (imposed mid-round by a :class:`SimEnv` crash
        fault, on top of any scheduled churn)."""
        self.downed[node] = max(until_round, self.downed.get(node, 0))

    def group_of(self, i: int) -> int:
        """Partition group index of node i this round (0 = no partition)."""
        for spec in self.config.partitions:
            if spec.start_round <= self.round < spec.end_round:
                for g, members in enumerate(spec.groups):
                    if i in members:
                        return g
        return 0

    def reachable(self, i: int, j: int) -> bool:
        alive = self.alive()
        return (i in alive and j in alive
                and self.group_of(i) == self.group_of(j))

    def components(self) -> List[Set[int]]:
        """Connected components among live nodes this round."""
        groups: Dict[int, Set[int]] = {}
        for i in self.alive():
            groups.setdefault(self.group_of(i), set()).add(i)
        return list(groups.values())

    # -- phase exchange ------------------------------------------------------
    _STAT_KEYS = ("sent", "delivered", "dropped", "unreachable", "timed_out",
                  "retransmits", "recovered", "gossip")

    def exchange(self, kind: str, payloads: Mapping[int, Any],
                 extra_delays: Optional[Mapping[int, float]] = None,
                 ) -> Dict[int, Dict[int, Any]]:
        """Broadcast each sender's payload to every other live node, then
        advance the clock to the phase deadline. Returns
        ``{receiver: {sender: payload}}`` for messages that were reachable,
        not dropped (or recovered by retransmission/gossip, per
        ``config.retry``), and arrived before the deadline — in arrival
        order, which is the order receivers process them.

        Stats per kind: ``unreachable`` counts partition/churn losses
        (topology — no retransmission can help), ``dropped`` stochastic
        link losses (each attempt, including retransmissions, draws
        independently), ``retransmits`` resends after a drop,
        ``recovered`` deliveries that needed at least one retransmission,
        and ``gossip`` deliveries made by the anti-entropy pass."""
        link = self.config.link
        retry = self.config.retry
        deadline = self.now + self.config.timeouts.get(kind, 60.0)
        stat = self.stats.setdefault(
            kind, {k: 0 for k in self._STAT_KEYS})
        # observability: one span per exchange (sim endpoints = start of
        # send → phase deadline) plus a per-message event stream. Every
        # emission below happens on the deterministic path — sorted loops,
        # seeded rng, heap order — so the event sequence is a pure function
        # of the seed. Guarded so the disabled path stays allocation-free.
        rec = get_recorder()
        traced = rec.enabled
        if traced:
            rec.open_span("net:" + kind, cat="network", round=self.round,
                          sim_now=self.now, kind=kind, **self._tag)
            stat_before = dict(stat)
        queue: List[Tuple[float, int, int, int, int]] = []
        for sender in sorted(payloads):
            delay = (extra_delays or {}).get(sender, 0.0)
            for recv in sorted(self.alive()):
                if recv == sender:
                    continue
                stat["sent"] += 1
                if not self.reachable(sender, recv):
                    stat["unreachable"] += 1
                    continue
                # multi-attempt delivery: each drop triggers a backed-off
                # retransmission while it still fits the phase deadline;
                # the first surviving copy is the one that travels
                send_at = self.now + delay
                for attempt in range(retry.max_retries + 1):
                    if attempt:
                        stat["retransmits"] += 1
                        if traced:
                            rec.event("net_retransmit", round=self.round,
                                      node=sender, sim_ms=send_at, kind=kind,
                                      recv=recv, attempt=attempt,
                                      **self._tag)
                    if (link.drop_rate > 0
                            and self.rng.random() < link.drop_rate):
                        stat["dropped"] += 1
                        if traced:
                            rec.event("net_drop", round=self.round,
                                      node=sender, sim_ms=send_at, kind=kind,
                                      recv=recv, attempt=attempt,
                                      **self._tag)
                        send_at += retry.backoff(attempt)
                        if send_at > deadline:
                            break   # every later copy lands past the deadline
                        continue
                    at = (send_at + link.base_latency
                          + float(self.rng.exponential(link.jitter)))
                    self._seq += 1
                    heapq.heappush(queue,
                                   (at, self._seq, sender, recv, attempt))
                    break
        deliveries: Dict[int, Dict[int, Any]] = {}
        first_arrival: Dict[int, float] = {}
        arrival: Dict[Tuple[int, int], float] = {}   # (recv, sender) -> at
        while queue:
            at, bus_seq, sender, recv, attempt = heapq.heappop(queue)
            if at > deadline:
                stat["timed_out"] += 1
                if traced:
                    rec.event("net_timeout", round=self.round, node=sender,
                              sim_ms=at, kind=kind, recv=recv,
                              bus_seq=bus_seq, attempt=attempt, **self._tag)
                continue
            stat["delivered"] += 1
            if attempt:
                stat["recovered"] += 1
            if traced:
                # emitted in heap-pop order (arrival time, bus seq) — the
                # canonical event order the determinism pin replays
                rec.event("net_delivery", round=self.round, node=recv,
                          sim_ms=at, kind=kind, sender=sender,
                          bus_seq=bus_seq, attempt=attempt, **self._tag)
            first_arrival.setdefault(sender, at)    # heap pops in time order
            arrival[(recv, sender)] = at
            deliveries.setdefault(recv, {})[sender] = payloads[sender]
        if retry.gossip:
            self._gossip_pass(kind, payloads, deliveries, first_arrival,
                              arrival, deadline, stat)
        # inclusion order: delivered senders by earliest arrival anywhere,
        # then never-delivered senders by id (they reach the chain last)
        self.last_order = sorted(first_arrival,
                                 key=lambda s: (first_arrival[s], s))
        self.last_order += [s for s in sorted(payloads)
                            if s not in first_arrival]
        self.now = deadline
        if traced:
            delta = {k: stat[k] - stat_before[k] for k in self._STAT_KEYS}
            for k, v in delta.items():
                if v:
                    rec.counter(f"net.{kind}.{k}", v)
            rec.event("net_exchange", round=self.round, sim_ms=deadline,
                      kind=kind, **delta, **self._tag)
            rec.close_span(sim_now=deadline, **delta)
        return deliveries

    def _gossip_pass(self, kind: str, payloads: Mapping[int, Any],
                     deliveries: Dict[int, Dict[int, Any]],
                     first_arrival: Dict[int, float],
                     arrival: Dict[Tuple[int, int], float],
                     deadline: float, stat: Dict[str, int]) -> None:
        """One pull-based anti-entropy pass: every live peer that missed a
        payload's direct copies pulls it from the earliest-holding
        reachable receiver (one forwarding attempt per missing pair, same
        link loss model). Mutates ``deliveries``/arrival maps in place."""
        link = self.config.link
        for sender in sorted(payloads):
            holders = sorted(
                (r for r in deliveries if sender in deliveries[r]),
                key=lambda r: (arrival[(r, sender)], r))
            if not holders:
                continue            # nobody to pull from
            for peer in sorted(self.alive()):
                if peer == sender or sender in deliveries.get(peer, {}):
                    continue
                source = next((h for h in holders
                               if self.reachable(h, peer)), None)
                if source is None:
                    stat["unreachable"] += 1
                    continue
                if link.drop_rate > 0 and self.rng.random() < link.drop_rate:
                    stat["dropped"] += 1
                    continue
                at = (arrival[(source, sender)] + link.base_latency
                      + float(self.rng.exponential(link.jitter)))
                if at > deadline:
                    stat["timed_out"] += 1
                    continue
                stat["gossip"] += 1
                rec = get_recorder()
                if rec.enabled:
                    rec.event("net_gossip_delivery", round=self.round,
                              node=peer, sim_ms=at, kind=kind, sender=sender,
                              source=source, **self._tag)
                arrival[(peer, sender)] = at
                deliveries.setdefault(peer, {})[sender] = payloads[sender]
                if (sender not in first_arrival
                        or at < first_arrival[sender]):
                    first_arrival[sender] = at

    def tx_landed(self, kind: str, senders: Iterable[int],
                  quorum: int) -> Set[int]:
        """Which senders' on-chain transactions landed before the tally
        deadline. The permissioned chain lives wherever a quorum of live
        nodes can talk to each other, so a transaction lands iff its sender
        sits in (or can reach) a component of ≥ quorum nodes and the
        submission itself isn't dropped — a ``RetrySpec`` grants each
        sender its retransmission attempts here too."""
        quorate = [c for c in self.components() if len(c) >= quorum]
        chain_nodes: Set[int] = set().union(*quorate) if quorate else set()
        drop = self.config.link.drop_rate
        attempts = self.config.retry.max_retries + 1
        stat = self.stats.setdefault(kind, {k: 0 for k in self._STAT_KEYS})
        landed = set()
        sender_ids = sorted(set(senders))
        for i in sender_ids:
            stat["sent"] += 1
            if i not in chain_nodes:
                stat["unreachable"] += 1
                continue
            for attempt in range(attempts):
                if attempt:
                    stat["retransmits"] += 1
                if drop > 0 and self.rng.random() < drop:
                    stat["dropped"] += 1
                    continue
                landed.add(i)
                stat["delivered"] += 1
                if attempt:
                    stat["recovered"] += 1
                break
        self.now += self.config.timeouts.get(kind, 60.0)
        rec = get_recorder()
        if rec.enabled:
            rec.event("net_tx_landed", round=self.round, sim_ms=self.now,
                      kind=kind, landed=sorted(landed),
                      submitted=len(sender_ids), **self._tag)
        return landed


class SimEnv:
    """The fault environment the consensus phases consult (duck-typed from
    ``repro_torch.core.phases``): the bus, the adversaries, the quorum, and the
    per-round observations that become the :class:`ScenarioReport`.

    Call order per round: :meth:`begin_round` → phases use the query /
    exchange methods → :meth:`end_round`; :meth:`finalize` heals the
    network, runs a last catch-up sync, and builds the report.
    """

    def __init__(self, network: SimNetwork,
                 adversaries: Sequence[Any] = (),
                 quorum: Optional[int] = None, seed: int = 0,
                 committee: Optional[Any] = None):
        self.network = network
        n = network.n_nodes
        # committee scope (repro_torch.core.committee.Committee): set when this
        # env hosts one shard of a consortium — node ids are then
        # committee-local and observations are tagged with the committee
        # id. The default quorum is ⌈2n/3⌉ either way, which for a
        # committee is ⌈2m/3⌉ over its *member* count.
        self.committee = committee
        self.quorum = quorum if quorum is not None else math.ceil(2 * n / 3)
        self.rng = np.random.default_rng(seed + 0x5EED)
        self._by_node: Dict[int, Any] = {}
        self._role: List[Any] = []      # role adversaries (e.g. LeaderCrash)
        for adv in adversaries:
            if getattr(adv, "node_id", None) is None:
                self._role.append(adv)
            else:
                if not (0 <= adv.node_id < n):
                    raise ValueError(
                        f"adversary {type(adv).__name__} names unknown node "
                        f"{adv.node_id} (n_nodes={n})")
                self._by_node[adv.node_id] = adv
        # mid-phase crash/restart faults (CrashRestart) — benign, so they
        # never count toward adversary_ids/honest_ids, but SimEnv drives
        # their crash, recovery-path restart, and rejoin
        self._crash_specs: List[Any] = [
            a for a in adversaries if getattr(a, "crash_fault", False)]
        self._fired_crashes: Set[int] = set()        # id(spec) of used specs
        self._pending_rejoin: Dict[int, int] = {}    # node -> rejoin round
        self.recoveries = 0          # WAL restarts + ledger-resync rejoins
        self.events: List[Dict[str, Any]] = []
        self.round_logs: List[Dict[str, Any]] = []
        # every block hash any honest node held at each height, accumulated
        # at round boundaries BEFORE sync/fork-choice can overwrite a
        # diverged chain — the evidence base for the safety-violation count
        self.height_hashes: Dict[int, set] = {}
        self._consensus = None

    # -- wiring --------------------------------------------------------------
    def bind(self, consensus: Any) -> None:
        """Attach the consensus driver whose ledgers/keys this env observes.

        Crash faults with ``amnesia=True`` lose their durable state here:
        the node's WAL is detached, so a restart replays nothing and its
        fresh re-commit is an (attributable) equivocation."""
        self._consensus = consensus
        hcds = getattr(consensus, "hcds_nodes", None)
        for spec in self._crash_specs:
            if spec.amnesia and spec.node_id is not None and hcds is not None:
                hcds[spec.node_id].wal = None
                getattr(consensus, "wals", {}).pop(spec.node_id, None)

    @property
    def adversary_ids(self) -> Set[int]:
        # crash faults are registered per-node but are benign (byzantine
        # = False): a node that merely crashed and recovered must stay in
        # the honest safety/leadership accounting
        return {i for i, a in self._by_node.items()
                if getattr(a, "byzantine", True)}

    def honest_ids(self) -> List[int]:
        adv = self.adversary_ids
        return [i for i in range(self.network.n_nodes) if i not in adv]

    def plagiarist_ids(self) -> Set[int]:
        return {i for i, a in self._by_node.items()
                if getattr(a, "plagiarizes", False)}

    # -- phase-facing protocol ----------------------------------------------
    def alive(self) -> Set[int]:
        return self.network.alive()

    def reachable_peers(self, i: int) -> List[int]:
        return [j for j in sorted(self.alive())
                if j != i and self.network.reachable(i, j)]

    def withholds_commit(self, i: int) -> bool:
        adv = self._by_node.get(i)
        return adv is not None and adv.withholds_commit(self.network.round)

    def withholds_vote(self, i: int) -> bool:
        adv = self._by_node.get(i)
        return adv is not None and adv.withholds_vote(self.network.round)

    def mutate_commit(self, i: int, commit: Any) -> Any:
        adv = self._by_node.get(i)
        return commit if adv is None else adv.mutate_commit(
            self.network.round, commit)

    def mutate_reveal(self, i: int, reveal: Any) -> Any:
        adv = self._by_node.get(i)
        return reveal if adv is None else adv.mutate_reveal(
            self.network.round, reveal)

    def mutate_vote_submission(self, i: int, submission: Any) -> Any:
        adv = self._by_node.get(i)
        return submission if adv is None else adv.mutate_vote_submission(
            self.network.round, submission)

    def adversary_vote(self, i: int, round: int, honest_vote: int,
                       preds: np.ndarray):
        adv = self._by_node.get(i)
        if adv is None:
            return None
        return adv.vote(round, self.network.n_nodes, honest_vote, preds,
                        self.rng)

    def leader_fails(self, candidate: int, round: int, attempt: int) -> bool:
        if candidate not in self.alive():
            return True
        adv = self._by_node.get(candidate)
        if adv is not None and adv.fails_as_leader(round, candidate, attempt):
            return True
        return any(r.fails_as_leader(round, candidate, attempt)
                   for r in self._role)

    def exchange(self, kind: str, round: int,
                 payloads: Mapping[int, Any]) -> Dict[int, Dict[int, Any]]:
        delays = {}
        for i in payloads:
            adv = self._by_node.get(i)
            if adv is not None:
                d = adv.extra_delay(kind, round)
                if d:
                    delays[i] = d
        return self.network.exchange(kind, payloads, extra_delays=delays)

    def last_exchange_order(self) -> List[int]:
        """Sender order of the most recent exchange by earliest
        network-wide delivery — the chain-inclusion order the commit phase
        uses as commitment precedence (one shared order, not per-receiver
        arrival, so every node resolves plagiarism ties identically)."""
        return list(self.network.last_order)

    def tx_landed(self, kind: str, round: int,
                  senders: Iterable[int]) -> Set[int]:
        return self.network.tx_landed(kind, senders, self.quorum)

    def note(self, event: str, **data: Any) -> None:
        """Record one environment observation.

        This is the single emission point for protocol observations: the
        same call feeds ``self.events`` (which ``build_report`` counts
        into the ``ScenarioReport`` security totals) and the active obs
        recorder's event stream — so the report counters and the exported
        event log can never disagree."""
        self.events.append({"event": event, **data})
        rec = get_recorder()
        if rec.enabled:
            attrs = dict(data)
            if self.committee is not None:
                attrs.setdefault("committee", self.committee.committee_id)
            rec.event(event, round=attrs.pop("round", None),
                      node=attrs.pop("node", None),
                      sim_ms=self.network.now, **attrs)

    # -- crash/restart faults ------------------------------------------------
    def crash_at(self, node: int, point: str, round: int) -> Optional[Any]:
        """The unfired :class:`~repro_torch.sim.adversary.CrashRestart` spec (if
        any) that kills ``node`` at phase boundary ``point`` this round.
        Role specs (``node_id=None``) match whichever node reaches the
        boundary — e.g. whoever was elected leader."""
        for spec in self._crash_specs:
            if spec.at != point or spec.in_round != round:
                continue
            if spec.node_id is not None and spec.node_id != node:
                continue
            if id(spec) in self._fired_crashes:
                continue
            return spec
        return None

    def execute_crash(self, spec: Any, node: int) -> bool:
        """Kill ``node`` per ``spec``: its volatile HCDS state is wiped on
        the spot. ``down_rounds == 0`` models a fast reboot within the
        same phase — the node comes back immediately through the recovery
        path (WAL replay, or nothing under amnesia) and the caller may let
        it resume; otherwise the node stays down and rejoins (ledger
        re-sync + WAL replay) at the start of round
        ``round + down_rounds``. Returns True iff the node is back up
        within the current phase."""
        from repro_torch.core import recovery
        self._fired_crashes.add(id(spec))
        self.note("node_crashed", round=self.network.round, node=node,
                  at=spec.at, amnesia=spec.amnesia)
        hnode = (self._consensus.hcds_nodes[node]
                 if self._consensus is not None else None)
        if hnode is not None:
            recovery.wipe_volatile(hnode)
        if spec.down_rounds <= 0:
            replayed = 0
            if hnode is not None and getattr(hnode, "wal", None) is not None:
                replayed = recovery.replay_wal(hnode, hnode.wal)
            self.recoveries += 1
            self.note("node_restarted", round=self.network.round, node=node,
                      wal_records=replayed, amnesia=spec.amnesia)
            return True
        until = self.network.round + spec.down_rounds
        self.network.force_down(node, until)
        self._pending_rejoin[node] = max(
            until, self._pending_rejoin.get(node, 0))
        return False

    def _rejoin(self, node: int, k: int) -> None:
        """The recovery path for a node whose downtime just ended: replay
        its protocol WAL into fresh HCDS state, then catch its ledger up
        from the best reachable peer chain."""
        from repro_torch.core import recovery
        replayed = adopted = 0
        if self._consensus is not None:
            hnode = self._consensus.hcds_nodes[node]
            recovery.wipe_volatile(hnode)
            if getattr(hnode, "wal", None) is not None:
                replayed = recovery.replay_wal(hnode, hnode.wal)
            peers = [self._consensus.ledgers[j]
                     for j in self.reachable_peers(node)]
            adopted = recovery.rejoin_ledger(
                self._consensus.ledgers[node], peers,
                self._consensus.public_keys)
        self.recoveries += 1
        self.note("node_rejoined", round=k, node=node,
                  wal_records=replayed, blocks_adopted=adopted)

    # -- round bookkeeping ---------------------------------------------------
    def begin_round(self, k: int) -> None:
        self.network.set_round(k)
        for node in sorted(self._pending_rejoin):
            if self._pending_rejoin[node] <= k:
                del self._pending_rejoin[node]
                self._rejoin(node, k)

    def end_round(self, k: int, metrics: Any, aborted: bool) -> None:
        from repro_torch.sim.report import snapshot_round
        self.round_logs.append(
            snapshot_round(self, k, metrics, aborted))

    def finalize(self, scenario: str, seed: int,
                 rounds_requested: int) -> Any:
        """Heal every fault, run the final catch-up sync among honest
        nodes, and assemble the :class:`~repro_torch.sim.report.ScenarioReport`."""
        from repro_torch.sim.report import build_report
        # heal: advance past every partition/churn/forced-down window
        last_fault = max(
            [s.end_round for s in self.network.config.partitions]
            + [c.down_until for c in self.network.config.churn
               if c.down_until < (1 << 30)]
            + list(self.network.downed.values()) + [0])
        self.network.set_round(max(self.network.round + 1, last_fault))
        self._final_sync()
        return build_report(self, scenario, seed, rounds_requested)

    def _final_sync(self) -> None:
        if self._consensus is None:
            return
        ledgers = self._consensus.ledgers
        pks = self._consensus.public_keys
        # only nodes still up after the heal can fetch blocks; a
        # permanently-crashed node keeps its stale chain (the report must
        # not claim a convergence the dead node never achieved)
        alive = self.network.alive()
        honest = [ledgers[i] for i in self.honest_ids() if i in alive]
        if not honest:
            return
        # longest chain wins; equal heights tie-break to the smaller head
        # hash — the same deterministic rule as Ledger.fork_choice
        best = sorted(honest, key=lambda l: (-l.height, l.head_hash))[0]
        for led in honest:
            if led is best or led.head_hash == best.head_hash:
                continue
            try:
                led.sync_from(best.blocks, pks)
            except Exception:
                led.fork_choice(best.blocks, pks)
