"""Span records — the dual-clock unit of the ``repro_torch.obs`` tracer.

A span measures one scoped piece of work (a consensus phase, a network
exchange, an FEL dispatch) on two clocks at once:

* **wall time** — ``time.perf_counter`` at open and close. This is the
  host-side cost the efficiency claims are about (how long did batch
  verification actually take), and it is *allowed* to differ between two
  replays of the same seed.
* **simulated bus time** — ``SimNetwork.now`` milliseconds, captured at
  open and close when the span runs under a networked round. This is
  protocol time: deterministic per seed, advanced only by phase
  deadlines, never by the host clock.

Keeping both on one record is what makes the critical-path report able
to say "22% of this round was commit-reveal retransmission stalls"
(wall) while the deterministic event log orders everything by bus
sequence (sim) — the two domains never mix, so tracing cannot
reintroduce the RA1xx nondeterminism class.

Spans nest on a stack per recorder: ``parent`` is the ``span_id`` of the
span that was open when this one opened (None for a top-level span such
as a BHFL round), ``depth`` its nesting depth. Exporters and the
profiler rebuild the tree from these ids — no interval arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class SpanRecord:
    """One finished span. ``wall_start``/``wall_dur`` are perf_counter
    seconds; ``sim_start``/``sim_end`` are bus milliseconds (None for
    spans that ran outside a simulated network, e.g. ideal-mode runs)."""

    span_id: int
    name: str
    cat: str
    round: Optional[int]
    node: Optional[int]
    parent: Optional[int]
    depth: int
    wall_start: float
    wall_dur: float
    sim_start: Optional[float] = None
    sim_end: Optional[float] = None
    error: Optional[str] = None
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def sim_dur(self) -> Optional[float]:
        """Simulated duration in ms, when both endpoints were captured."""
        if self.sim_start is None or self.sim_end is None:
            return None
        return self.sim_end - self.sim_start


class _OpenSpan:
    """Stack entry for a span that has been opened but not yet closed."""

    __slots__ = ("span_id", "name", "cat", "round", "node", "parent",
                 "depth", "wall_start", "sim_start", "sim_env", "attrs")

    def __init__(self, span_id: int, name: str, cat: str,
                 round: Optional[int], node: Optional[int],
                 parent: Optional[int], depth: int, wall_start: float,
                 sim_start: Optional[float], sim_env: Optional[Any],
                 attrs: Dict[str, Any]):
        self.span_id = span_id
        self.name = name
        self.cat = cat
        self.round = round
        self.node = node
        self.parent = parent
        self.depth = depth
        self.wall_start = wall_start
        self.sim_start = sim_start
        self.sim_env = sim_env
        self.attrs = attrs


def sim_now(env: Optional[Any]) -> Optional[float]:
    """The simulated bus clock of ``env`` (a duck-typed SimEnv), or None
    outside a networked round — the single place the tracer reads it."""
    if env is None:
        return None
    network = getattr(env, "network", None)
    if network is None:
        return None
    return float(network.now)
