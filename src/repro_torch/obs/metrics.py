"""MetricsRegistry — counters, gauges, and histograms for one run.

The registry is the aggregate side of the tracer: spans and events
capture *when*, metrics capture *how much* (WAL appends, batch-verify
sizes, compile-cache hits, dispatch latencies). A snapshot rolls into
``ScenarioReport.obs_metrics`` and ``BHFLRun.obs``.

Counters and gauges are deterministic per seed (they count protocol
facts). Histograms typically hold wall-clock latencies, so their
*values* vary between replays — which is why snapshots live next to,
never inside, the deterministic event log.
"""

from __future__ import annotations

from typing import Any, Dict, List


def _percentile(sorted_values: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted non-empty list."""
    rank = max(0, min(len(sorted_values) - 1,
                      int(round(q / 100.0 * (len(sorted_values) - 1)))))
    return sorted_values[rank]


def summarize_values(values: List[float]) -> Dict[str, float]:
    """The stable summary shape used for every histogram snapshot."""
    if not values:
        return {"count": 0, "sum": 0.0, "mean": 0.0,
                "p50": 0.0, "p90": 0.0, "p99": 0.0, "max": 0.0}
    s = sorted(values)
    total = float(sum(s))
    return {
        "count": len(s),
        "sum": total,
        "mean": total / len(s),
        "p50": _percentile(s, 50),
        "p90": _percentile(s, 90),
        "p99": _percentile(s, 99),
        "max": s[-1],
    }


class MetricsRegistry:
    """Name-keyed counters/gauges/histograms with a sorted snapshot."""

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, List[float]] = {}

    def counter(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + float(value)

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        self.histograms.setdefault(name, []).append(float(value))

    def percentiles(self, name: str) -> Dict[str, float]:
        return summarize_values(self.histograms.get(name, []))

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready rollup; keys sorted so the shape is stable."""
        return {
            "counters": {k: self.counters[k] for k in sorted(self.counters)},
            "gauges": {k: self.gauges[k] for k in sorted(self.gauges)},
            "histograms": {k: summarize_values(self.histograms[k])
                           for k in sorted(self.histograms)},
        }
