"""repro_torch.obs — the recorder seam of the port.

A copy of the reference's span/event recorder (``repro.obs``): the
process-wide default is a no-op :class:`NullRecorder`, and a
:class:`TraceRecorder` scoped with :func:`use_recorder` captures the
spans, events and metrics of everything inside its block. The Perfetto
export and the profile CLI are not ported yet.
"""

from repro_torch.obs.events import (SECURITY_EVENTS, ObsEvent,
                                    validate_security_event)
from repro_torch.obs.metrics import MetricsRegistry, summarize_values
from repro_torch.obs.recorder import (NullRecorder, Recorder, TraceRecorder,
                                      get_recorder, phase_span_after,
                                      phase_span_before, set_recorder,
                                      use_recorder)
from repro_torch.obs.spans import SpanRecord, sim_now

__all__ = [
    "SECURITY_EVENTS", "ObsEvent", "validate_security_event",
    "MetricsRegistry", "summarize_values",
    "NullRecorder", "Recorder", "TraceRecorder", "get_recorder",
    "phase_span_after", "phase_span_before", "set_recorder", "use_recorder",
    "SpanRecord", "sim_now",
]
