"""Observability: distributed query tracing and the flight recorder
(histogram metrics, scheduler self-profiler, per-query resource ledgers),
the Perfetto timeline export (``perfetto.py``) and EXPLAIN ANALYZE's
renderer (``explain.py``).

Span propagation follows the OpenTelemetry shape the reference's operator
``MetricsSet`` machinery approximates: a root span opens at client submit,
trace context rides RPC string maps (``ExecuteQueryParams.settings`` /
``TaskDefinition.props``), completed spans ship back piggybacked on task
status updates, and the scheduler retains them per-job in a bounded
``TraceStore`` exposed via ``EXPLAIN ANALYZE``, ``GET /api/trace/{job_id}``
(Chrome/Perfetto ``trace_event`` JSON) and the stage-metrics log.
"""
from ballista_tpu_torch.obs.tracing import (  # noqa: F401
    PARENT_PROP,
    TRACE_ID_PROP,
    Span,
    SpanCollector,
    TraceStore,
    ambient,
    ambient_span,
    clear_ambient,
    new_span_id,
    new_trace_id,
    set_ambient,
    stage_span_id,
)
from ballista_tpu_torch.obs.metrics import (  # noqa: F401
    FlightRecorder,
    Histogram,
    PromText,
    TimeSeries,
    escape_label_value,
    fmt_labels,
)
from ballista_tpu_torch.obs.profiler import (  # noqa: F401
    SamplingProfiler,
    profile_for,
)
from ballista_tpu_torch.obs.ledger import (  # noqa: F401
    QueryLedger,
    build_ledger,
    ledger_from_metrics,
)
