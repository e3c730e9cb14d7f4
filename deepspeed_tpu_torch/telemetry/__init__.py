"""Telemetry: the metrics registry, exporters, the profiler window, the
step-heartbeat watchdog, the request/step tracer, and the engines'
metric catalogs (ported from the JAX package's telemetry/).

``manager.build_telemetry`` wires all of it from an engine's config, and
``manager.register_serving_metrics`` gives the fleet router its
``fleet/*`` catalog. ``hub.TelemetryHub`` (over ``timeseries``) is the
networked fleet's observability plane.
"""

from .exporters import (
    JsonlExporter,
    MetricExporter,
    PrometheusTextfileExporter,
    SummaryWriterExporter,
    prometheus_name,
    render_prometheus,
)
from .hub import HUB_HTTP_PATHS, TelemetryHub
from .manager import (
    ENGINE_METRICS,
    INFERENCE_METRICS,
    Telemetry,
    build_telemetry,
    register_inference_metrics,
)
from .profiling import ProfilerWindow
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import (
    NOOP_TRACER,
    NoopTracer,
    SpanTracer,
    TraceContext,
    build_tracer,
    load_chrome_trace,
)
from .timeseries import TimeSeriesStore
from .watchdog import StepHeartbeatWatchdog

__all__ = [
    "Counter",
    "ENGINE_METRICS",
    "Gauge",
    "HUB_HTTP_PATHS",
    "Histogram",
    "INFERENCE_METRICS",
    "JsonlExporter",
    "MetricExporter",
    "MetricsRegistry",
    "NOOP_TRACER",
    "NoopTracer",
    "PrometheusTextfileExporter",
    "ProfilerWindow",
    "SpanTracer",
    "StepHeartbeatWatchdog",
    "SummaryWriterExporter",
    "Telemetry",
    "TelemetryHub",
    "TimeSeriesStore",
    "TraceContext",
    "build_telemetry",
    "build_tracer",
    "load_chrome_trace",
    "prometheus_name",
    "render_prometheus",
    "register_inference_metrics",
]
