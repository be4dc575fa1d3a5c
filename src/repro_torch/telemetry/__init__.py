"""``repro_torch.telemetry`` — spans, counters, gauges, peak memory and
Chrome-trace / JSONL export (the port of the JAX package's tracer; the
comm-volume ledger comes later, ROADMAP.md queue A)."""
from repro_torch.telemetry.metrics import MetricsSink
from repro_torch.telemetry.tracer import (NULL_TRACER, NullTracer, SpanEvent,
                                          Tracer, device_peak_memory)

__all__ = ["MetricsSink", "NULL_TRACER", "NullTracer", "SpanEvent", "Tracer",
           "device_peak_memory"]
