"""Spans on the host and the device's trace, reduced to what the metrics
read.

``Spans`` records named intervals on the host clock around the calls the
benchmark makes into the program; with ``sync`` each interval starts and
ends with a ``torch.cuda.synchronize()``, so it holds the device work the
call enqueued. ``profile`` runs a function under ``torch.profiler`` with
the device's activity alone (host tracing would slow the host by an
order of magnitude and read as idle device time). A marker kernel
launched right after a synchronize at a known host time puts the host
spans on the device's clock, so an idle gap
can be charged to the span the host was in. The profiler can lose the
first records of a session and its last (on the H100, the last ~150 of
~25,000 in one session of four): markers go before the clock's marker
and after the function, and a trace in which no marker after the
function arrived is not ``complete``.
"""

from __future__ import annotations

import re
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host intervals by name: ``with spans("local_step"): ...``. Nested
    spans are kept; ``totals`` sums each name's time."""

    def __init__(self, device, sync_each: bool):
        self.device, self.sync_each = device, sync_each
        self.events: List[Tuple[str, float, float, int]] = []
        self.depth = 0

    @contextmanager
    def __call__(self, name: str):
        if self.sync_each:
            sync(self.device)
        t0 = time.perf_counter()
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1
            if self.sync_each:
                sync(self.device)
            self.events.append((name, t0, time.perf_counter(), self.depth))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, t0, t1, _ in self.events:
            out[name] = out.get(name, 0.0) + (t1 - t0)
        return out

    def count(self, name: str) -> int:
        return sum(1 for e in self.events if e[0] == name)

    def innermost(self, t: float) -> str:
        """The deepest span open at host time ``t``, or "harness"."""
        best, depth = "harness", -1
        for name, t0, t1, d in self.events:
            if t0 <= t < t1 and d > depth:
                best, depth = name, d
        return best


# the marker kernel (``torch.cuda._sleep``), which the program never runs
MARKER = "spin_kernel"
LEAD, TAIL = 64, 2048


@dataclass
class DeviceTrace:
    """Device activity of a profiled window, on the host's clock
    (seconds); the markers left out."""
    intervals: List[Tuple[float, float, str]]   # (start, end, name)
    window: Tuple[float, float]                  # host clock
    by_name: Dict[str, float] = field(default_factory=dict)
    count_by_name: Dict[str, int] = field(default_factory=dict)
    complete: bool = True

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """The union of the device's intervals inside the window."""
        busy, end = 0.0, float("-inf")
        for t0, t1, _ in self.intervals:
            busy += max(0.0, t1 - max(t0, end))
            end = max(end, t1)
        return busy

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals of the device inside the window, longest
        first."""
        out, cursor = [], self.window[0]
        for t0, t1, _ in self.intervals:
            if t0 > cursor:
                out.append((cursor, t0))
            cursor = max(cursor, t1)
        if self.window[1] > cursor:
            out.append((cursor, self.window[1]))
        return sorted(out, key=lambda g: g[0] - g[1])

    def kernel_seconds(self, symbols: Sequence[str]) -> float:
        """Device seconds of the kernels whose name holds one of
        ``symbols`` as a whole identifier."""
        pat = _symbols(symbols)
        return sum(t for n, t in self.by_name.items() if pat.search(n))

    def kernel_count(self, symbols: Sequence[str]) -> int:
        """Records of the kernels whose name holds one of ``symbols``."""
        pat = _symbols(symbols)
        return sum(c for n, c in self.count_by_name.items()
                   if pat.search(n))

    def top(self, n: int = 10) -> List[list]:
        return [[name, secs] for name, secs in sorted(
            self.by_name.items(), key=lambda kv: -kv[1])[:n]]


def _symbols(symbols: Sequence[str]):
    return re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
        map(re.escape, symbols)) + r")(?![A-Za-z0-9_])")


def _mark() -> None:
    torch.cuda._sleep(100)


def warm_profiler(device) -> None:
    """One throwaway session: a process's first profiler session can come
    back without device records."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1024, device=device)
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]):
        (x + 1).sum()
        sync(device)


def profile(fn, device) -> Tuple[object, DeviceTrace]:
    """``fn()`` under ``torch.profiler`` (device activity only): its
    result and the device trace, on the host clock. Returns an empty
    trace where the profiler saw nothing."""
    from torch.profiler import ProfilerActivity, profile as _profile
    sync(device)
    with _profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the first records of a session can be lost: the markers that
        # set the clock go after a few of their own
        for _ in range(LEAD):
            _mark()
        sync(device)
        t_mark = time.perf_counter()
        _mark()
        result = fn()
        sync(device)
        t_end = time.perf_counter()
        for _ in range(TAIL):
            _mark()
        sync(device)
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return result, reduce(spans, t_mark, t_end)


def reduce(spans: list, t_mark: float, t_end: float) -> DeviceTrace:
    """The device trace from the profiler's kernel records (start and
    end in µs on the device's clock, name), the clock's marker launched
    at host time ``t_mark`` and the function done at ``t_end``."""
    spans = sorted(spans)
    own = [s for s in spans if MARKER not in s[2]]
    lead = [s for s in spans if MARKER in s[2]
            and (not own or s[0] < own[0][0])]
    if not lead:
        return DeviceTrace([], (t_mark, t_end), complete=False)
    offset = t_mark - lead[-1][0] * 1e-6     # the last leading marker
    intervals = [(t0 * 1e-6 + offset, t1 * 1e-6 + offset, n)
                 for t0, t1, n in own]
    by_name: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for t0, t1, name in intervals:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
        count[name] = count.get(name, 0) + 1
    tail = len(spans) - len(own) - len(lead)
    return DeviceTrace(intervals, (t_mark, t_end), by_name, count,
                       complete=tail > 0)


def idle_by_span(trace: DeviceTrace, spans: Optional[Spans],
                 n: int = 10) -> List[list]:
    """Device idle time inside the window, summed by the host span open
    at each gap's middle, most first."""
    out: Dict[str, float] = {}
    for g0, g1 in trace.gaps():
        name = spans.innermost(0.5 * (g0 + g1)) if spans else "harness"
        out[name] = out.get(name, 0.0) + (g1 - g0)
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]
