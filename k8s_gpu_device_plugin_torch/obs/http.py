"""Payload builders for the ``/debug/*`` observability endpoints.

The port's copy of ``k8s_gpu_device_plugin_tpu/obs/http.py``, for the
port's ``http.server`` handler (``serving/server.py``): the span label
of a request is its route's template, the query parser and the trace
payloads are the reference's.
"""

from __future__ import annotations

from k8s_gpu_device_plugin_torch.obs.export import to_chrome_trace
from k8s_gpu_device_plugin_torch.obs.trace import Tracer


def route_label(handler) -> str:
    """Bounded span-operation label for a request on the port's
    ``http.server`` handler: the template of the route it matched in the
    server's route table (``/debug/traces/{trace_id}``), never the raw
    path. Span names feed the (component, operation) histogram labels,
    and raw paths (scanners, random 404s) would grow the registry without
    bound. Unmatched requests collapse to one label."""
    return getattr(handler, "route_template", None) or "unmatched"


#: telemetry READ paths: health probes, metric scrapes, trace/timeline
#: fetches. A root span per read would churn the bounded finished-trace
#: ring these endpoints read, evicting the real request traces.
_OBSERVATION_PATHS = ("/v1/health", "/metrics")
_OBSERVATION_PREFIXES = ("/debug/",)


def is_observation_path(path: str) -> bool:
    """True for telemetry-read endpoints: such a request may JOIN a trace
    (incoming ``traceparent``) but never START one."""
    return path in _OBSERVATION_PATHS or any(
        path.startswith(p) for p in _OBSERVATION_PREFIXES
    )


def parse_trace_query(query, since_desc: str = "start_us timestamp",
                      ) -> tuple["int | None", "int | None"]:
    """``?limit=``/``?since=`` parsing for the trace endpoints and the
    router's fleet event journal: ``limit`` caps the page, ``since``
    returns only entries past the cursor (the incremental-poll idiom).
    ``query`` maps a name to its value; ``since_desc`` names the cursor's
    unit in the error (``start_us`` on the trace planes, an event ``seq``
    on the journal). Raises ValueError on malformed values (the server
    answers 400)."""
    limit = since = None
    raw = query.get("limit")
    if raw is not None:
        try:
            limit = int(raw)
        except ValueError:
            raise ValueError(f"limit must be an integer, got {raw!r}") \
                from None
        if limit < 0:
            raise ValueError(f"limit must be >= 0, got {limit}")
    raw = query.get("since")
    if raw is not None:
        try:
            since = int(raw)
        except ValueError:
            raise ValueError(
                f"since must be an integer {since_desc}, got {raw!r}"
            ) from None
    return limit, since


def traces_payload(tracer: Tracer, limit: "int | None" = None,
                   since_us: "int | None" = None) -> dict:
    """``GET /debug/traces``: buffer state + newest-first summaries.
    ``total`` reports the whole buffer, so a limited page is told apart
    from a small buffer."""
    traces = tracer.traces()
    total = len(traces)
    if since_us is not None:
        traces = [t for t in traces if t["start_us"] > since_us]
    if limit is not None:
        traces = traces[:limit]  # newest-first: the limit keeps the newest
    return {
        "enabled": tracer.enabled,
        "total": total,
        "returned": len(traces),
        "traces": traces,
    }


def trace_detail_payload(tracer: Tracer, trace_id: str) -> "dict | None":
    """``GET /debug/traces/{id}``: one trace as Chrome/Perfetto JSON, or
    None when the id is not in the buffer."""
    spans = tracer.get_trace(trace_id)
    if spans is None:
        return None
    return to_chrome_trace(spans)
