"""repro_torch.obs — dual-clock tracing, metrics, and round profiling.

A span-based tracer threaded through the whole stack: consensus phases
(via the ``add_phase_hook`` seam), network exchanges, crypto batch
verification, FEL dispatch, and WAL recovery all report into one
process-wide :class:`Recorder`. The default recorder is a no-op — the
disabled path stores nothing and adds zero protocol state — and a
:class:`TraceRecorder` scoped with :func:`use_recorder` captures
everything inside its block.

See OBSERVABILITY.md for the span model, clock domains, and exporter
formats; ``python -m repro_torch.obs summarize --help`` for the CLI.
"""

from repro_torch.obs.events import (SECURITY_EVENTS, ObsEvent,
                                    validate_security_event)
from repro_torch.obs.export import (chrome_trace, events_jsonl,
                                    write_chrome_trace, write_events_jsonl)
from repro_torch.obs.metrics import MetricsRegistry, summarize_values
from repro_torch.obs.profile import (critical_paths, events_to_trace,
                                     format_summary, load_trace,
                                     phase_percentiles)
from repro_torch.obs.recorder import (NullRecorder, Recorder, TraceRecorder,
                                      get_recorder, phase_span_after,
                                      phase_span_before, record_collector,
                                      set_recorder, use_recorder)
from repro_torch.obs.spans import SpanRecord, sim_now

__all__ = [
    "SECURITY_EVENTS", "ObsEvent", "validate_security_event",
    "chrome_trace", "events_jsonl", "write_chrome_trace",
    "write_events_jsonl",
    "MetricsRegistry", "summarize_values",
    "critical_paths", "events_to_trace", "format_summary", "load_trace",
    "phase_percentiles",
    "NullRecorder", "Recorder", "TraceRecorder", "get_recorder",
    "phase_span_after", "phase_span_before", "record_collector",
    "set_recorder", "use_recorder",
    "SpanRecord", "sim_now",
]
