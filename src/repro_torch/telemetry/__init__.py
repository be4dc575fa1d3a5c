"""``repro_torch.telemetry`` — spans, counters, gauges, peak memory and
Chrome-trace / JSONL export (the port of the JAX package's tracer), and
the comm-volume ledger's ``CommLedger`` (the per-step training ledger
waits for ROADMAP.md A.8)."""
from repro_torch.telemetry.ledger import Collective, CommLedger
from repro_torch.telemetry.metrics import MetricsSink
from repro_torch.telemetry.tracer import (NULL_TRACER, NullTracer, SpanEvent,
                                          Tracer, device_peak_memory)

__all__ = ["Collective", "CommLedger", "MetricsSink", "NULL_TRACER",
           "NullTracer", "SpanEvent", "Tracer", "device_peak_memory"]
