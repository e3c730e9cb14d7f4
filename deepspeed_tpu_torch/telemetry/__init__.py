"""Telemetry: the metrics registry, the request tracer, and the serving
engine's ``infer/*`` catalog (ported from the JAX package)."""

from .manager import INFERENCE_METRICS, register_inference_metrics
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import NOOP_TRACER, TraceContext

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "INFERENCE_METRICS",
    "MetricsRegistry",
    "NOOP_TRACER",
    "TraceContext",
    "register_inference_metrics",
]
