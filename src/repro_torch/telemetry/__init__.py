"""``repro_torch.telemetry`` — spans, counters, gauges, peak memory and
Chrome-trace / JSONL export (the port of the JAX package's tracer), and
the comm-volume ledger (``CommLedger``, ``train_step_ledger``)."""
from repro_torch.telemetry.ledger import (LEDGER_HEADS, Collective,
                                          CommLedger, train_step_ledger)
from repro_torch.telemetry.metrics import MetricsSink
from repro_torch.telemetry.tracer import (NULL_TRACER, NullTracer, SpanEvent,
                                          Tracer, device_peak_memory)

__all__ = ["Collective", "CommLedger", "LEDGER_HEADS", "MetricsSink",
           "NULL_TRACER", "NullTracer", "SpanEvent", "Tracer",
           "device_peak_memory", "train_step_ledger"]
