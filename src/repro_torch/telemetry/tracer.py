"""``Tracer`` — nestable low-overhead spans + counters/gauges + export.

The port of the JAX package's tracer; design constraints
(docs/telemetry.md):

  * The hot path must pay ~nothing when telemetry is disabled: callers
    hold a ``Tracer`` OR the shared ``NULL_TRACER`` singleton behind the
    same interface, and every ``NULL_TRACER`` method is a constant-time
    no-op returning preallocated objects (the ``_NullSpan`` instance
    counter shows the hot path allocates nothing).
  * Spans nest: ``span()`` keeps an explicit stack and records the depth
    at exit, so the exported Chrome trace reconstructs the hierarchy
    without thread-local magic.
  * The clock is injectable (``clock_ns=``) so tests drive a fake clock
    and span timing is deterministic.

Export formats:
  * ``chrome_trace()`` / ``write_chrome_trace(path)`` — the Chrome
    tracing/Perfetto JSON object format (``traceEvents`` with complete
    "X" events, timestamps in microseconds); open at https://ui.perfetto.dev.
  * ``log_metrics(row)`` — one JSON object per line into the optional
    ``MetricsSink`` (``metrics_path=``).
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, NamedTuple, Optional

from repro_torch.telemetry.metrics import MetricsSink


class SpanEvent(NamedTuple):
    """One closed span: start/duration on the tracer's ns clock, nesting
    depth at entry (0 = top level), and optional attributes."""
    name: str
    start_ns: int
    dur_ns: int
    depth: int
    attrs: Optional[dict]


class _Span:
    """Context manager recording one span into its tracer on exit."""

    __slots__ = ("_tr", "name", "attrs", "start_ns", "depth")

    def __init__(self, tracer: "Tracer", name: str, attrs: Optional[dict]):
        self._tr = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self.depth = len(self._tr._stack)
        self._tr._stack.append(self.name)
        self.start_ns = self._tr.clock_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end_ns = self._tr.clock_ns()
        self._tr._stack.pop()
        self._tr.events.append(SpanEvent(
            self.name, self.start_ns, end_ns - self.start_ns, self.depth,
            self.attrs))
        return False


class Tracer:
    """Span/counter/gauge registry. See module docstring."""

    enabled = True

    def __init__(self, *, clock_ns: Callable[[], int] = time.perf_counter_ns,
                 metrics_path: Optional[str] = None):
        self.clock_ns = clock_ns
        self.events: list[SpanEvent] = []
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, Any] = {}
        self._stack: list[str] = []
        self.sink = MetricsSink(metrics_path) if metrics_path else None

    # -- spans -------------------------------------------------------------

    def span(self, name: str, attrs: Optional[dict] = None) -> _Span:
        return _Span(self, name, attrs)

    def add_span(self, name: str, start_ns: int, dur_ns: int,
                 attrs: Optional[dict] = None, depth: int = 0) -> None:
        """Record an externally-timed interval (e.g. the serving engine's
        own ``perf_counter_ns`` compute window) as a span."""
        self.events.append(
            SpanEvent(name, int(start_ns), int(dur_ns), depth, attrs))

    def span_stats(self, name: str) -> dict:
        """{"count", "total_s"} over every recorded span named ``name``."""
        n, total_ns = 0, 0
        for e in self.events:
            if e.name == name:
                n += 1
                total_ns += e.dur_ns
        return {"count": n, "total_s": total_ns * 1e-9}

    # -- counters / gauges -------------------------------------------------

    def count(self, name: str, value: float = 1.0) -> float:
        v = self.counters.get(name, 0.0) + value
        self.counters[name] = v
        return v

    def gauge(self, name: str, value) -> None:
        self.gauges[name] = value

    def record_peak_memory(self, prefix: str = "mem.peak_bytes") -> dict:
        """Gauge the current peak-memory watermark per device (host RSS
        fallback on backends without ``memory_stats``)."""
        peaks = device_peak_memory()
        for dev, b in peaks.items():
            self.gauge(f"{prefix}.{dev}", b)
        return peaks

    # -- metrics sink ------------------------------------------------------

    def log_metrics(self, row: dict) -> None:
        if self.sink is not None:
            self.sink.write(row)

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()

    # -- export ------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The Chrome tracing / Perfetto JSON object format. Timestamps
        are microseconds on the tracer's monotonic clock; counters and
        gauges ride along as (tolerated) extra top-level keys."""
        events = []
        for e in self.events:
            ev = {"name": e.name, "ph": "X", "ts": e.start_ns / 1e3,
                  "dur": e.dur_ns / 1e3, "pid": 0, "tid": 0,
                  "args": {"depth": e.depth, **(e.attrs or {})}}
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "counters": dict(self.counters), "gauges": dict(self.gauges)}

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path


# ---------------------------------------------------------------------------
# disabled path
# ---------------------------------------------------------------------------

_ZERO_STATS = {"count": 0, "total_s": 0.0}


class _NullSpan:
    """The no-op span. Exactly ONE instance ever exists (the module-level
    ``_NULL_SPAN``); the class-level counter lets tests assert the hot
    path allocates nothing."""

    __slots__ = ()
    instances = 0

    def __new__(cls):
        cls.instances += 1
        return super().__new__(cls)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: same interface as ``Tracer``, every call a no-op
    that allocates nothing. Use the shared ``NULL_TRACER`` singleton."""

    enabled = False
    events: tuple = ()

    def span(self, name, attrs=None):
        return _NULL_SPAN

    def add_span(self, name, start_ns, dur_ns, attrs=None, depth=0):
        pass

    def span_stats(self, name):
        return _ZERO_STATS

    def count(self, name, value=1.0):
        return 0.0

    def gauge(self, name, value):
        pass

    def record_peak_memory(self, prefix="mem.peak_bytes"):
        return {}

    def log_metrics(self, row):
        pass

    def close(self):
        pass


NULL_TRACER = NullTracer()


# ---------------------------------------------------------------------------
# peak-memory watermarks
# ---------------------------------------------------------------------------


def device_peak_memory() -> dict:
    """Peak-memory watermark per CUDA device
    (``torch.cuda.max_memory_allocated``), with the process high-water RSS
    as the host fallback when no card is present."""
    import torch

    peaks = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            peaks[str(i)] = int(torch.cuda.max_memory_allocated(i))
    if not peaks:
        import resource
        peaks["host_rss"] = (
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    return peaks
