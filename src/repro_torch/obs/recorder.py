"""Recorders — the instrumentation sink behind every ``repro_torch.obs`` call.

Two implementations share one interface:

* :class:`NullRecorder` — the process-wide default. Every method is a
  no-op and ``span()`` returns one shared do-nothing context manager, so
  an instrumented call site costs a module-global read plus an empty
  method call. The disabled path stores nothing, allocates nothing
  per-call, and adds zero protocol state — traces stay bit-deterministic
  per seed whether or not the import exists.
* :class:`TraceRecorder` — buffers :class:`SpanRecord`/:class:`ObsEvent`
  streams plus a :class:`MetricsRegistry`. Spans nest on a stack;
  events get a monotonically increasing ``seq`` at emission. Every
  emission site sits on a seeded deterministic code path, so the event
  stream replays byte-identically for a seed (pinned by
  ``tests/test_determinism_smoke.py``).

A :class:`TraceRecorder` given a CUDA ``device`` also takes the device's
readings at each span's open and close (``SpanRecord.device_ms``,
``alloc_bytes``, ``mem_start_bytes``, ``mem_bytes``): a timing event on
the current stream and one read of the caching allocator's statistics
each. It never synchronizes: :meth:`TraceRecorder.resolve` turns the
event pairs into ``device_ms`` once the caller's work is done.
:func:`record_collector` adds a ``gc`` span for each pass of the garbage
collector.

The active recorder is module state, swapped with
:func:`set_recorder`/:func:`use_recorder`. Instrumented modules call
:func:`get_recorder` at each site (never caching it across calls), so a
scoped recorder sees everything inside its ``with`` block and nothing
outside.

Read-only contract: a recorder observes ``RoundContext``/``SimEnv``
state but never mutates it — hook functions here only *read* the
context they are handed (enforced statically by analysis rule RA151).
"""

from __future__ import annotations

import gc
import itertools
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

import torch

from repro_torch.obs.events import ObsEvent, validate_security_event
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.spans import SpanRecord, _OpenSpan
from repro_torch.obs.spans import sim_now as _env_sim_now


class _NoopSpan:
    """The shared context manager the disabled path hands out."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class Recorder:
    """The no-op base interface (also the NullRecorder implementation)."""

    enabled: bool = False

    # -- spans ---------------------------------------------------------------
    def span(self, name: str, **kw: Any) -> Any:
        return _NOOP_SPAN

    def open_span(self, name: str, *, cat: str = "obs",
                  round: Optional[int] = None, node: Optional[int] = None,
                  sim_now: Optional[float] = None,
                  sim_env: Optional[Any] = None, **attrs: Any) -> None:
        pass

    def close_span(self, *, sim_now: Optional[float] = None,
                   error: Optional[str] = None, **attrs: Any) -> None:
        pass

    def depth(self) -> int:
        return 0

    def unwind(self, depth: int, error: Optional[str] = None) -> None:
        pass

    def collector_pass(self, phase: str, info: Dict[str, int]) -> None:
        pass

    # -- events --------------------------------------------------------------
    def event(self, name: str, *, round: Optional[int] = None,
              node: Optional[int] = None, sim_ms: Optional[float] = None,
              **attrs: Any) -> None:
        pass

    # -- metrics -------------------------------------------------------------
    def counter(self, name: str, value: float = 1.0) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def observe(self, name: str, value: float) -> None:
        pass

    def metrics_snapshot(self) -> Dict[str, Any]:
        return {}


class NullRecorder(Recorder):
    """The default: tracing off, every call a no-op."""


class _SpanCM:
    """Context-manager wrapper over open_span/close_span for one span."""

    __slots__ = ("_rec", "_name", "_kw")

    def __init__(self, rec: "TraceRecorder", name: str, kw: Dict[str, Any]):
        self._rec = rec
        self._name = name
        self._kw = kw

    def __enter__(self) -> "TraceRecorder":
        self._rec.open_span(self._name, **self._kw)
        return self._rec

    def __exit__(self, et: Any, ev: Any, tb: Any) -> bool:
        self._rec.close_span(error=et.__name__ if et is not None else None)
        return False


class TraceRecorder(Recorder):
    """Buffering recorder: spans + events + metrics for one traced run.

    ``label`` names the run (e.g. the scenario) in multi-run exports.
    ``device``: where it is a CUDA device, each span carries the device's
    readings (see :mod:`repro_torch.obs.spans`); elsewhere they are None.
    """

    enabled = True

    def __init__(self, label: str = "run",
                 device: Optional[torch.device | str] = None):
        self.label = label
        self.spans: List[SpanRecord] = []
        self.events: List[ObsEvent] = []
        self.metrics = MetricsRegistry()
        self._stack: List[_OpenSpan] = []
        # ids from one counter: a collector pass that fires inside
        # open_span takes an id of its own, never the opening span's
        self._ids = itertools.count()
        self._next_seq = 0
        dev = None if device is None else torch.device(device)
        self._cuda = dev if dev is not None and dev.type == "cuda" else None
        self._pending: List[tuple] = []     # (record, start, end) events
        self._gc_start: Optional[float] = None

    # -- spans ---------------------------------------------------------------
    def span(self, name: str, **kw: Any) -> _SpanCM:
        return _SpanCM(self, name, kw)

    def _device_reading(self) -> Optional[tuple]:
        """(a timing event recorded on the current stream, the allocator's
        cumulative and current allocated bytes), or None without a card.
        Reads no tensor and waits for nothing."""
        if self._cuda is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._cuda))
        # the allocator's own nested dict: ``memory_stats`` flattens it in
        # Python, ~0.2 ms a call on the H100's host
        stats = torch.cuda.memory_stats_as_nested_dict(self._cuda)
        got = stats.get("allocated_bytes", {}).get("all", {})
        return ev, got.get("allocated", 0), got.get("current", 0)

    def open_span(self, name: str, *, cat: str = "obs",
                  round: Optional[int] = None, node: Optional[int] = None,
                  sim_now: Optional[float] = None,
                  sim_env: Optional[Any] = None, **attrs: Any) -> None:
        start_sim = sim_now
        if start_sim is None and sim_env is not None:
            start_sim = _env_sim_now(sim_env)
        parent = self._stack[-1].span_id if self._stack else None
        span = _OpenSpan(next(self._ids), name, cat, round, node, parent,
                         len(self._stack), time.perf_counter(), start_sim,
                         sim_env, dict(attrs), self._device_reading())
        self._stack.append(span)

    def close_span(self, *, sim_now: Optional[float] = None,
                   error: Optional[str] = None, **attrs: Any) -> None:
        if not self._stack:
            return      # tolerate an unmatched close rather than raise
        end = self._device_reading()
        open_span = self._stack.pop()
        end_sim = sim_now
        if end_sim is None and open_span.sim_env is not None:
            end_sim = _env_sim_now(open_span.sim_env)
        merged = open_span.attrs
        if attrs:
            merged = dict(merged)
            merged.update(attrs)
        record = SpanRecord(
            span_id=open_span.span_id, name=open_span.name,
            cat=open_span.cat, round=open_span.round, node=open_span.node,
            parent=open_span.parent, depth=open_span.depth,
            wall_start=open_span.wall_start,
            wall_dur=time.perf_counter() - open_span.wall_start,
            sim_start=open_span.sim_start, sim_end=end_sim,
            error=error, attrs=merged)
        start = open_span.device
        if start is not None and end is not None:
            record.alloc_bytes = end[1] - start[1]
            record.mem_start_bytes, record.mem_bytes = start[2], end[2]
            self._pending.append((record, start[0], end[0]))
        self.spans.append(record)

    def resolve(self) -> None:
        """Set ``device_ms`` of every span closed since the last call from
        its two events. Call it once the spans' device work is done (after
        the caller's synchronize); it waits on each closing event."""
        for record, start, end in self._pending:
            end.synchronize()
            record.device_ms = start.elapsed_time(end)
        self._pending.clear()

    def collector_pass(self, phase: str, info: Dict[str, int]) -> None:
        """A ``gc.callbacks`` entry (see :func:`record_collector`): a
        ``gc`` span (cat ``host``) from a pass's start to its stop, with
        its ``generation`` and ``collected``, under whatever span is
        open. It touches neither the stack nor an open span, so a pass
        that fires inside ``open_span`` or ``close_span`` leaves both
        intact."""
        if phase == "start":
            self._gc_start = time.perf_counter()
            return
        start, self._gc_start = self._gc_start, None
        if start is None:
            return
        top = self._stack[-1] if self._stack else None
        self.spans.append(SpanRecord(
            span_id=next(self._ids), name="gc", cat="host", round=None,
            node=None, parent=None if top is None else top.span_id,
            depth=len(self._stack), wall_start=start,
            wall_dur=time.perf_counter() - start,
            attrs={"generation": info["generation"],
                   "collected": info["collected"]}))

    def depth(self) -> int:
        return len(self._stack)

    def unwind(self, depth: int, error: Optional[str] = None) -> None:
        """Close every span above ``depth`` — the exception path for
        hook-paired spans whose closing hook never ran (a phase raised)."""
        while len(self._stack) > depth:
            self.close_span(error=error or "unwound")

    # -- events --------------------------------------------------------------
    def event(self, name: str, *, round: Optional[int] = None,
              node: Optional[int] = None, sim_ms: Optional[float] = None,
              **attrs: Any) -> None:
        validate_security_event(name, node)
        self.events.append(ObsEvent(
            seq=self._next_seq, name=name, round=round, node=node,
            sim_ms=sim_ms, wall_ts=time.perf_counter(), attrs=dict(attrs)))
        self._next_seq += 1

    # -- metrics -------------------------------------------------------------
    def counter(self, name: str, value: float = 1.0) -> None:
        self.metrics.counter(name, value)

    def gauge(self, name: str, value: float) -> None:
        self.metrics.gauge(name, value)

    def observe(self, name: str, value: float) -> None:
        self.metrics.observe(name, value)

    def metrics_snapshot(self) -> Dict[str, Any]:
        return self.metrics.snapshot()


_NULL = NullRecorder()
_ACTIVE: Recorder = _NULL


def get_recorder() -> Recorder:
    """The active recorder (the NullRecorder unless one was installed)."""
    return _ACTIVE


def set_recorder(rec: Optional[Recorder]) -> Recorder:
    """Install ``rec`` (None restores the NullRecorder); returns the
    previously active recorder so callers can restore it."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = rec if rec is not None else _NULL
    return prev


@contextmanager
def use_recorder(rec: Recorder) -> Iterator[Recorder]:
    """Scope ``rec`` as the active recorder for a ``with`` block."""
    prev = set_recorder(rec)
    try:
        yield rec
    finally:
        set_recorder(prev)


@contextmanager
def record_collector(rec: Recorder) -> Iterator[Recorder]:
    """Record each pass of the garbage collector in ``rec`` as a ``gc``
    span for a ``with`` block (a ``gc.callbacks`` entry, removed on exit
    and on an exception); nothing for a recorder that stores nothing."""
    if not rec.enabled:
        yield rec
        return
    hook = rec.collector_pass
    gc.callbacks.append(hook)
    try:
        yield rec
    finally:
        gc.callbacks.remove(hook)


# ---------------------------------------------------------------------------
# The consensus phase-hook pair (registered via consensus.add_phase_hook)
# ---------------------------------------------------------------------------

def phase_span_before(phase: str, ctx: Any) -> None:
    """Open a ``phase:<name>`` span when a consensus phase starts.

    Read-only with respect to ``ctx`` (RA151): it reads the round number,
    the committee scope, and the env's bus clock, and touches nothing
    else. Committee-scoped rounds tag the span so the profiler can drill
    per-committee critical paths; unsharded rounds carry no extra attr
    (their traces stay byte-identical to the pre-shard pipeline).
    """
    committee = getattr(ctx, "committee", None)
    if committee is not None:
        get_recorder().open_span("phase:" + phase, cat="consensus",
                                 round=ctx.round,
                                 sim_now=_env_sim_now(ctx.env),
                                 committee=committee.committee_id)
        return
    get_recorder().open_span("phase:" + phase, cat="consensus",
                             round=ctx.round, sim_now=_env_sim_now(ctx.env))


def phase_span_after(phase: str, ctx: Any) -> None:
    """Close the span ``phase_span_before`` opened for this phase."""
    get_recorder().close_span(sim_now=_env_sim_now(ctx.env))
