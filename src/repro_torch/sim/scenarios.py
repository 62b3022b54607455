"""Named fault/adversary scenarios for the BHFL simulator.

Each :class:`Scenario` bundles a network condition (latency, loss,
partitions, churn), an adversary cast, and the run sizing; resolve one by
name with :func:`get_scenario` and run it via
``api.run_bhfl(scenario="byzantine_third")`` or
``repro_torch.sim.run_scenario("byzantine_third")``. Register additional
scenarios with :func:`register` — experiments are encouraged to define
their own rather than hand-wiring ``SimEnv`` objects.

All scenarios are sized for CPU CI (tiny synthetic MNIST, one FEL
iteration) — the point is protocol behaviour under faults, not learning
curves.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.sim.adversary import (Adversary, BriberyVoter,
                                       CommitWithholder, CrashRestart,
                                       EnvelopeForger, LazyLeader, LeaderCrash,
                                       Plagiarist, RevealEquivocator)
from repro_torch.sim.network import (ChurnSpec, LinkSpec, NetworkConfig,
                                     PartitionSpec, RetrySpec)


@dataclass(frozen=True)
class Scenario:
    """A named, reproducible fault configuration for one BHFL run."""

    name: str
    description: str
    rounds: int = 6
    n_nodes: int = 6
    clients_per_node: int = 2
    fel_iterations: int = 1
    net: NetworkConfig = field(default_factory=NetworkConfig)
    adversaries: Tuple[Adversary, ...] = ()
    quorum: int = 0              # 0 = default ceil(2N/3)
    n_train: int = 512           # synthetic data sizing (speed, not accuracy)
    n_test: int = 128
    slow: bool = False           # excluded from the CI scenario-smoke job
    # -- sharded consortium (repro_torch.fl.consortium) ---------------------------
    # committees > 1 partitions the N nodes into that many committee-scoped
    # PoFEL instances (contiguous balanced split, or committee_sizes when
    # given). Node ids in ``adversaries``/``net.churn`` stay GLOBAL and are
    # remapped into their committee; ``net.partitions`` are unsupported
    # with committees > 1 (shard the consortium via ``cross_net`` instead).
    committees: int = 1
    committee_sizes: Optional[Tuple[int, ...]] = None
    # rounds between checkpoint epochs (each committee emits a certified
    # checkpoint block and merges its peers' via the cross-shard bus)
    checkpoint_interval: int = 2
    # the K-endpoint cross-shard bus config; None inherits link/retry from
    # ``net``. Partitions here split *committees*, ids 0..K-1.
    cross_net: Optional[NetworkConfig] = None


SCENARIOS: Dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    if scenario.name in SCENARIOS:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; available: "
                       f"{', '.join(sorted(SCENARIOS))}") from None


def list_scenarios(include_slow: bool = True) -> Tuple[str, ...]:
    return tuple(sorted(n for n, s in SCENARIOS.items()
                        if include_slow or not s.slow))


# ---------------------------------------------------------------------------
# The registry. Adversary node ids cluster at the top of the id range so
# scenario reports read naturally (honest nodes first).
# ---------------------------------------------------------------------------

register(Scenario(
    name="ideal",
    description="No faults — the paper's synchronous lossless world; the "
                "networked pipeline must match its ideal-mode behaviour.",
    rounds=4,
))

register(Scenario(
    name="lossy_wan",
    description="Every link drops 8% of messages with 10±8 ms latency — "
                "commits/reveals/blocks go missing, quorums still form, "
                "stragglers converge via catch-up sync.",
    net=NetworkConfig(link=LinkSpec(base_latency=10.0, jitter=8.0,
                                    drop_rate=0.08)),
))

register(Scenario(
    name="partitioned_edges",
    description="Nodes {4,5} split from the majority for rounds 2-3: the "
                "quorate side keeps minting, the minority falls behind, "
                "heals, and reconverges through catch-up sync.",
    rounds=7,
    net=NetworkConfig(partitions=(
        PartitionSpec(groups=((0, 1, 2, 3), (4, 5)),
                      start_round=2, end_round=4),)),
))

register(Scenario(
    name="byzantine_third",
    description="⌊N/3⌋ colluding bribery voters (one targeted on a "
                "colluder, one random) — BTSV must keep electing honest "
                "leaders with zero safety violations.",
    adversaries=(BriberyVoter(4, mode="targeted", target=4),
                 BriberyVoter(5, mode="random")),
))

register(Scenario(
    name="leader_crash",
    description="The elected leader crashes at mint time in rounds 1 and "
                "3 — BlockMint must re-elect down the advote ranking "
                "without losing liveness.",
    adversaries=(LeaderCrash(rounds=(1, 3)),),
))

register(Scenario(
    name="lazy_leader",
    description="Node 5 participates fully but never mints when elected; "
                "rounds it wins trigger a re-election instead of a stall.",
    adversaries=(LazyLeader(5),),
))

register(Scenario(
    name="commit_withholder",
    description="Node 5 never broadcasts its commitment: its model misses "
                "the reveal quorum and is excluded from Eq. 1/votes.",
    rounds=4,
    adversaries=(CommitWithholder(5),),
))

register(Scenario(
    name="reveal_equivocator",
    description="Node 5 commits to its trained model but reveals forged "
                "bytes; HCDS digest checks reject it at every honest node.",
    rounds=4,
    adversaries=(RevealEquivocator(5),),
))

register(Scenario(
    name="forged_envelopes",
    description="Node 5 signs its commit and vote envelopes with a key it "
                "does not own: the round-level batch verification fails, "
                "bisects, and attributes exactly its envelopes — honest "
                "traffic in the same batch is untouched.",
    rounds=4,
    adversaries=(EnvelopeForger(5),),
))

register(Scenario(
    name="edge_churn",
    description="Node 5 crashes for rounds 2-3 and rejoins: consensus "
                "proceeds on the live quorum, the rejoiner catches up.",
    net=NetworkConfig(churn=(ChurnSpec(node=5, down_from=2, down_until=4),)),
))

register(Scenario(
    name="plagiarist",
    description="Node 3 copies the first honest node's model every round; "
                "HCDS rejects the duplicate reveal, so the plagiarist "
                "never enters ME and never leads (§3.2).",
    rounds=3,
    n_nodes=4,
    adversaries=(Plagiarist(3),),
))

register(Scenario(
    name="lossy_wan_retry",
    description="Every link drops 40% of messages — far past what the "
                "one-shot bus survives (expected reveal quorum < 2N/3, "
                "rounds abort). Bounded-backoff retransmission plus one "
                "anti-entropy gossip pass keeps every quorum alive.",
    rounds=5,
    net=NetworkConfig(link=LinkSpec(base_latency=5.0, jitter=4.0,
                                    drop_rate=0.4),
                      retry=RetrySpec(max_retries=3, base_backoff=4.0,
                                      backoff_factor=2.0, gossip=True)),
))

register(Scenario(
    name="crash_restart",
    description="Mid-phase crash/restart with durable WALs: node 3 "
                "fast-reboots inside round 1's commit→reveal window (WAL "
                "replay re-issues the identical commit), node 4 crashes "
                "after voting in round 2 and rejoins one round later via "
                "ledger re-sync, and round 3's elected leader dies after "
                "minting but before broadcast — peers re-elect; the "
                "signed block exists only in the dead leader's WAL.",
    rounds=6,
    adversaries=(CrashRestart(3, at="after_commit", round=1, down_rounds=0),
                 CrashRestart(4, at="after_vote", round=2, down_rounds=1),
                 CrashRestart(None, at="after_mint", round=3,
                              down_rounds=1)),
))

register(Scenario(
    name="amnesia_restart",
    description="Node 5 fast-reboots inside round 1's commit window with "
                "NO WAL: it re-commits under a fresh nonce for a round it "
                "already committed — honest peers detect and attribute "
                "the commit-equivocation and the round completes without "
                "it (detection, not a crash).",
    rounds=4,
    adversaries=(CrashRestart(5, at="after_commit", round=1, down_rounds=0,
                              amnesia=True),),
))

register(Scenario(
    name="bribery_targeted",
    description="§7.4 TA: 3 of 8 nodes always vote node 7 (a colluder); "
                "BTSV collapses their vote weights and the honest argmax "
                "keeps winning.",
    rounds=10,
    n_nodes=8,
    adversaries=(BriberyVoter(5, mode="targeted", target=7),
                 BriberyVoter(6, mode="targeted", target=7),
                 BriberyVoter(7, mode="targeted", target=7)),
))

register(Scenario(
    name="bribery_random",
    description="§7.4 RA: 3 of 8 nodes vote uniformly at random; BTSV "
                "down-weights the noise voters.",
    rounds=10,
    n_nodes=8,
    adversaries=(BriberyVoter(5, mode="random"),
                 BriberyVoter(6, mode="random"),
                 BriberyVoter(7, mode="random")),
))

# ---------------------------------------------------------------------------
# Sharded consortium scenarios: K committee-scoped PoFEL instances with
# cross-shard checkpoint sync (repro_torch.fl.consortium). Sized so the fast
# trio fits the CI consortium-smoke job; consortium_256 is the scale run.
# ---------------------------------------------------------------------------

register(Scenario(
    name="consortium_64",
    description="4 committees of 16 over a mildly lossy WAN: each shard "
                "runs its own PoFEL instance, emits a ≥2/3-certified "
                "checkpoint every 2 rounds, and merges peers' checkpoints "
                "on the top-chain — per-committee liveness with zero "
                "global safety violations.",
    rounds=4,
    n_nodes=64,
    clients_per_node=1,
    committees=4,
    checkpoint_interval=2,
    n_train=256,
    n_test=64,
    net=NetworkConfig(link=LinkSpec(base_latency=5.0, jitter=2.0,
                                    drop_rate=0.01),
                      retry=RetrySpec(max_retries=2)),
))

register(Scenario(
    name="consortium_partitioned",
    description="4 committees whose cross-shard bus splits 2|2 during the "
                "middle checkpoint epochs: top-chains fork across the cut "
                "(each side keeps certifying checkpoints), then heal and "
                "reconverge via fork choice — concurrent checkpoints under "
                "a partition are not safety violations.",
    rounds=4,
    n_nodes=64,
    clients_per_node=1,
    committees=4,
    checkpoint_interval=1,
    n_train=256,
    n_test=64,
    net=NetworkConfig(retry=RetrySpec(max_retries=2)),
    cross_net=NetworkConfig(
        partitions=(PartitionSpec(groups=((0, 1), (2, 3)),
                                  start_round=1, end_round=3),),
        retry=RetrySpec(max_retries=2)),
))

register(Scenario(
    name="consortium_committee_crash",
    description="A committee member crashes after voting and stays down "
                "across a checkpoint epoch: its committee certifies the "
                "checkpoint without it (quorum is over members, not "
                "survivors), and the member rejoins mid-epoch via WAL "
                "replay + ledger re-sync in time to countersign the next "
                "one.",
    rounds=4,
    n_nodes=64,
    clients_per_node=1,
    committees=4,
    checkpoint_interval=2,
    n_train=256,
    n_test=64,
    net=NetworkConfig(retry=RetrySpec(max_retries=2)),
    adversaries=(CrashRestart(17, at="after_vote", round=1, down_rounds=2),),
))

register(Scenario(
    name="consortium_256",
    description="The scale run: 8 committees of 32 (N=256). Round "
                "wall-time tracks the committee size (~N/K), not the "
                "consortium (~N²) — the headline BENCH_consortium.json "
                "measures; the report must show all-true per-committee "
                "liveness and zero global safety violations.",
    rounds=4,
    n_nodes=256,
    clients_per_node=1,
    committees=8,
    checkpoint_interval=2,
    n_train=512,
    n_test=64,
    net=NetworkConfig(link=LinkSpec(base_latency=5.0, jitter=2.0,
                                    drop_rate=0.01),
                      retry=RetrySpec(max_retries=2)),
    slow=True,
))
