"""Observability (counterpart of :mod:`rl_tpu.obs`; the on-device step
metrics, the host metrics registry and the trace recorder are ported)."""

from .device import DeviceMetrics
from .registry import Counter, Gauge, Histogram, MetricsRegistry, get_registry, set_registry
from .trace import (TraceContext, TraceRecorder, carry_context, ctx_args, current_context,
                    get_tracer, new_trace, set_tracer, use_context, wire_tracer_obs)

__all__ = ["Counter", "DeviceMetrics", "Gauge", "Histogram", "MetricsRegistry", "TraceContext",
           "TraceRecorder", "carry_context", "ctx_args", "current_context", "get_registry",
           "get_tracer", "new_trace", "set_registry", "set_tracer", "use_context",
           "wire_tracer_obs"]
