"""Observability (counterpart of :mod:`rl_tpu.obs`; the on-device step
metrics, the host metrics registry, the trace recorder, the SLO engine,
the flight recorder and the HTTP sidecar are ported; ``profiling`` and
``drift`` wait for ROADMAP A7)."""

from .device import DeviceMetrics
from .flight import FlightRecorder, get_flight_recorder, set_flight_recorder
from .http import MetricsHTTPServer
from .registry import Counter, Gauge, Histogram, MetricsRegistry, get_registry, set_registry
from .slo import Objective, SLOEngine, StreamingHistogram, merge_histograms
from .trace import (TraceContext, TraceRecorder, carry_context, ctx_args, current_context,
                    get_tracer, new_trace, set_tracer, use_context, wire_tracer_obs)

__all__ = ["Counter", "DeviceMetrics", "FlightRecorder", "Gauge", "Histogram",
           "MetricsHTTPServer", "MetricsRegistry", "Objective", "SLOEngine",
           "StreamingHistogram", "TraceContext", "TraceRecorder", "carry_context", "ctx_args",
           "current_context", "get_flight_recorder", "get_registry", "get_tracer",
           "merge_histograms", "new_trace", "set_flight_recorder", "set_registry", "set_tracer",
           "use_context", "wire_tracer_obs"]
