"""Observability: span tracing with trace<->log<->metric correlation.

The port's copy of ``k8s_gpu_device_plugin_tpu/obs/``:

- ``trace.py``  — standard-library ``Tracer``/``Span`` with contextvars
  propagation (thread hops through ``attach``), a ring buffer of
  completed traces, and W3C ``traceparent`` interop;
- ``export.py`` — Chrome/Perfetto trace-event JSON for any trace in the
  buffer (``GET /debug/traces/{id}`` serves it);
- ``prom.py``   — span-duration histograms per (component, operation)
  on a server's registry, driven by the tracer's end-of-span listener;
- ``attribution.py`` — per-request latency attribution (phase
  timelines that sum exactly to each request's wall time) and the
  tail-latency flight recorder (``GET /debug/slow``);
- ``http.py``   — the ``/debug/traces`` query parser and payloads;
- ``fleet_obs.py`` — the replica router's event journal, request
  timelines and flight recorder (``serving/router.py``; nothing of it is
  re-exported here, as in the reference).

``utils/log.py`` stamps the active ``trace_id``/``span_id`` on every JSON
record. Off by default: every instrumentation site is behind one
``tracer.enabled`` check.
"""

from k8s_gpu_device_plugin_torch.obs.trace import (
    NOOP_SPAN,
    Span,
    SpanContext,
    Tracer,
    attach,
    configure,
    current_context,
    current_trace_ids,
    format_traceparent,
    get_tracer,
    parse_traceparent,
)

__all__ = [
    "NOOP_SPAN",
    "Span",
    "SpanContext",
    "Tracer",
    "attach",
    "configure",
    "current_context",
    "current_trace_ids",
    "format_traceparent",
    "get_tracer",
    "parse_traceparent",
]
