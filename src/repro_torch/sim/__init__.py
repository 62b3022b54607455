"""``repro_torch.sim`` — event-driven BHFL network simulator with adversary and
fault scenarios.

The paper's security claims (HCDS stops plagiarism, BTSV defeats bribery,
the permissioned chain removes the single point of failure) are exercised
here under non-ideal conditions: a deterministic seeded message bus
(latency, drops, partitions, churn — :mod:`repro_torch.sim.network`), a library
of Byzantine behaviours (:mod:`repro_torch.sim.adversary`), and a registry of
named scenarios (:mod:`repro_torch.sim.scenarios`), each producing a typed
:class:`~repro_torch.sim.report.ScenarioReport` of liveness, safety violations,
honest-leader rate, and recovery time.

    from repro_torch import sim
    report = sim.run_scenario("byzantine_third", seed=0)
    report.liveness, report.safety_violations, report.honest_leader_rate

or through the facade — ``api.run_bhfl(scenario="byzantine_third")``.
"""

from repro_torch.sim.adversary import (Adversary, BriberyVoter,
                                       CommitWithholder, CrashRestart,
                                       EnvelopeForger, LazyLeader, LeaderCrash,
                                       Plagiarist, RevealEquivocator)
from repro_torch.sim.network import (ChurnSpec, LinkSpec, NetworkConfig,
                                     PartitionSpec, RetrySpec, SimEnv,
                                     SimNetwork)
from repro_torch.sim.report import (CommitteeReport, RoundReport,
                                    ScenarioReport, merge_consortium_report)
from repro_torch.sim.runner import build_env, run_scenario
from repro_torch.sim.scenarios import (SCENARIOS, Scenario, get_scenario,
                                       list_scenarios, register)

__all__ = [
    "run_scenario", "build_env",
    "Scenario", "SCENARIOS", "get_scenario", "list_scenarios", "register",
    "ScenarioReport", "RoundReport", "CommitteeReport",
    "merge_consortium_report",
    "SimNetwork", "SimEnv", "NetworkConfig", "LinkSpec", "PartitionSpec",
    "ChurnSpec", "RetrySpec",
    "Adversary", "Plagiarist", "BriberyVoter", "CommitWithholder",
    "RevealEquivocator", "EnvelopeForger", "LazyLeader", "LeaderCrash",
    "CrashRestart",
]
