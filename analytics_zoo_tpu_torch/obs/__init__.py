"""Unified observability layer: metrics registry, Prometheus/JSON
export, request tracing, and the
flight recorder (structured event log + crash postmortems).

One vocabulary for serving AND training instrumentation (the reference
split this between the serving ``Timer``/dashboard publisher and BigDL
training ``Metrics``): every subsystem registers
``zoo_<subsystem>_<name>_<unit>`` instruments in the process-wide
registry; ``HttpFrontend`` exposes it at ``GET /metrics`` (Prometheus
text) and ``GET /metrics.json``; spans ride requests through the
serving pipeline and export as Chrome trace-event JSON; typed events
(obs.events, one vocabulary in ``EVENT_TYPES``) land in a bounded ring
served at ``GET /debug/events``, and on crash obs.flight dumps a
postmortem bundle (events + metrics + spans + in-flight request ids +
config). See docs/observability.md.
"""

from analytics_zoo_tpu_torch.obs.events import (  # noqa: F401
    EVENT_TYPES,
    EventLog,
    RecompileDetector,
    check_event_type,
    emit,
    get_event_log,
    get_recompile_detector,
    instrument_compiles,
    is_warming,
    record_compile,
    register_event_type,
    warming,
)
from analytics_zoo_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder,
    InflightRequests,
    get_flight_recorder,
    get_inflight,
    install_flight_recorder,
    uninstall_flight_recorder,
)
from analytics_zoo_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    METRIC_NAME_RE,
    MetricsRegistry,
    StatCore,
    check_metric_name,
    get_registry,
)
from analytics_zoo_tpu_torch.obs.tracing import (  # noqa: F401
    Tracer,
    current_trace_id,
    get_tracer,
    maybe_trace,
    new_trace_id,
    trace_context,
)

__all__ = [
    "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram",
    "METRIC_NAME_RE", "MetricsRegistry", "StatCore",
    "check_metric_name", "get_registry",
    "Tracer", "current_trace_id", "get_tracer", "maybe_trace",
    "new_trace_id", "trace_context",
    "EVENT_TYPES", "EventLog", "RecompileDetector", "check_event_type",
    "emit", "get_event_log", "get_recompile_detector",
    "instrument_compiles", "is_warming", "record_compile",
    "register_event_type", "warming",
    "FlightRecorder", "InflightRequests", "get_flight_recorder",
    "get_inflight", "install_flight_recorder",
    "uninstall_flight_recorder",
]
