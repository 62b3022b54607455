"""Typed observability events and the security-audit event registry.

An :class:`ObsEvent` is one instantaneous fact with a deterministic
identity: its ``seq`` (the recorder's emission counter — all emission
sites sit on seeded, deterministic code paths, so the sequence replays
bit-identically per seed) and its simulated-bus timestamp. Wall time is
captured too, but only for the Perfetto view; the JSONL event log never
contains it, which is what makes two same-seed replays byte-identical.

``SECURITY_EVENTS`` is the typed registry of protocol-violation events:
each one MUST carry an attributed ``node`` id. ``SimEnv.note`` mirrors
every environment observation into the active recorder, so the
``ScenarioReport`` security counters (which are computed from the same
``env.events`` list) and the obs event log can never disagree — one call
site feeds both.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

#: Security-audit event kinds: attributed protocol violations. A recorder
#: rejects one of these without a ``node`` id — attribution is the point.
#:
#:   envelope_rejected      — forged signature envelope, attributed signer
#:                            (commit / reveal / vote)
#:   equivocation_detected  — conflicting signed statements across a
#:                            crash/restart (amnesia faults)
#:   plagiarism_evicted     — HCDS commit-precedence tie-break evicted a
#:                            copied model
#:   commit_withheld        — an adversary withheld its commit this round
SECURITY_EVENTS = frozenset({
    "envelope_rejected",
    "equivocation_detected",
    "plagiarism_evicted",
    "commit_withheld",
})


@dataclass
class ObsEvent:
    """One instantaneous observation. ``seq`` is the recorder-assigned
    emission index (the deterministic order); ``sim_ms`` the bus clock at
    emission (None outside a networked round); ``wall_ts`` perf_counter
    seconds, used only by the Perfetto exporter."""

    seq: int
    name: str
    round: Optional[int]
    node: Optional[int]
    sim_ms: Optional[float]
    wall_ts: float
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def is_security(self) -> bool:
        return self.name in SECURITY_EVENTS


def validate_security_event(name: str, node: Optional[int]) -> None:
    """Enforce the registry contract: security events carry attribution."""
    if name in SECURITY_EVENTS and node is None:
        raise ValueError(
            f"security event {name!r} requires an attributed node id "
            f"(node=...); refusing an unattributed security observation")
