"""Chrome/Perfetto trace-event JSON exporter.

The port's copy of ``k8s_gpu_device_plugin_tpu/obs/export.py``. The
span records in the tracer's
ring buffer convert 1:1 into the trace-event format's complete events
(``"ph": "X"``), which both ``chrome://tracing`` and
https://ui.perfetto.dev open directly. Rows group by component: each
component becomes a named "thread" via ``thread_name`` metadata events,
so a serving request renders as admit -> prefill -> decode -> retire
nested under its request span. :func:`to_fleet_chrome_trace` renders a
stitched fleet trace (``obs/fleet_obs.py``) with one process row per
track.
"""

from __future__ import annotations

import os


def _span_events(spans: list[dict], pid: int) -> list[dict]:
    """Span records -> complete events + thread_name metadata under one
    Chrome 'process' (``pid``); components become that process's named
    threads."""
    components: dict[str, int] = {}
    events: list[dict] = []
    for span in spans:
        component = span.get("component") or "default"
        tid = components.setdefault(component, len(components) + 1)
        args = {
            "trace_id": span["trace_id"],
            "span_id": span["span_id"],
            "parent_id": span.get("parent_id"),
            "status": span.get("status", "ok"),
            "thread": span.get("thread", ""),
        }
        attrs = span.get("attrs") or {}
        for key, value in attrs.items():
            # keep the payload JSON-serializable whatever landed in attrs
            args[key] = (
                value if isinstance(value, (str, int, float, bool, type(None)))
                else str(value)
            )
        events.append({
            "name": span["name"],
            "cat": component,
            "ph": "X",
            "ts": span["start_us"],
            "dur": max(span["dur_us"], 1),  # 0-width events vanish in the UI
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    for component, tid in components.items():
        events.append({
            "name": "thread_name",
            "ph": "M",
            "pid": pid,
            "tid": tid,
            "args": {"name": component},
        })
    return events


def to_chrome_trace(spans: list[dict]) -> dict:
    """Span records (Tracer.get_trace output) -> trace-event JSON dict."""
    return {
        "traceEvents": _span_events(spans, os.getpid()),
        "displayTimeUnit": "ms",
    }



def to_fleet_chrome_trace(tracks: "list[tuple[str, list[dict]]]") -> dict:
    """Stitched per-track span lists (obs/fleet_obs.stitch_spans) -> ONE
    Perfetto-openable document: each track — the router, each replica —
    renders as its own named process row (``process_name`` metadata,
    ``pid`` = track index), with that track's components as threads
    inside it. Timestamps are the spans' own wall-clock microseconds,
    so rows from different replicas align on the shared clock the
    ``traceparent`` propagation already rides."""
    events: list[dict] = []
    for pid, (track, spans) in enumerate(tracks, start=1):
        events.extend(_span_events(spans, pid))
        events.append({
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "args": {"name": track},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
