"""Span-based tracing core: ``Tracer``/``Span`` + context propagation.

The port's copy of ``k8s_gpu_device_plugin_tpu/obs/trace.py``: the same
ring, the same span records, the same ``traceparent`` interop. Standard
library only: ``utils/log.py`` imports it for trace-field injection, and
the serving loop runs through it per request, so the disabled path is
one attribute read and a branch.

Design:

- **Propagation** is a single ``contextvars.ContextVar`` holding the
  active span. Threads do not inherit it: the serving engine's request
  threads capture it with :func:`current_context` and the engine thread
  restores it with :func:`attach` around the batcher's ``submit``.
- **Completion** is structural, not root-based: the tracer counts open
  spans per trace and moves a trace to the finished ring buffer when the
  count drops to zero, so a child ending after its parent (common across
  threads) never strands a trace in the live table.
- **W3C interop**: ``traceparent`` headers parse to a
  :class:`SpanContext` and any span formats back out, so the HTTP server
  joins caller traces and propagates onward.
"""

from __future__ import annotations

import contextlib
import contextvars
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass

#: The one propagation slot. Holds a Span (in-process parent) or a
#: SpanContext (remote parent from a traceparent header), or None.
_ACTIVE: contextvars.ContextVar["Span | SpanContext | None"] = (
    contextvars.ContextVar("gpu_obs_active_span", default=None)
)

TRACEPARENT_HEADER = "traceparent"

#: Sentinel: "resolve the parent from the ambient context".
_FROM_CONTEXT: object = object()


@dataclass(frozen=True)
class SpanContext:
    """The portable identity of a span: what crosses process/thread
    boundaries (and the wire, as a ``traceparent``)."""

    trace_id: str  # 32 lowercase hex chars
    span_id: str   # 16 lowercase hex chars


def new_trace_id() -> str:
    return secrets.token_hex(16)


def new_span_id() -> str:
    return secrets.token_hex(8)


def format_traceparent(ctx: "Span | SpanContext") -> str:
    """W3C trace-context header value (version 00, sampled flag set)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(value: str | None) -> SpanContext | None:
    """Parse a ``traceparent`` header; None for anything malformed.

    Accepts any version byte except the reserved ``ff`` (per spec,
    future versions must stay parseable as version 00)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or version.lower() == "ff":
        return None
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(version, 16)
        if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
            return None  # all-zero ids are explicitly invalid
    except ValueError:
        return None
    return SpanContext(trace_id=trace_id.lower(), span_id=span_id.lower())


class Span:
    """One timed operation. Usable as a context manager (sets the
    ambient context for its body) or via explicit :meth:`end` for
    lifetimes that cross threads (the serving request tree)."""

    __slots__ = (
        "tracer", "name", "component", "trace_id", "span_id", "parent_id",
        "attrs", "status", "_start_wall", "_start_perf", "_dur", "_token",
        "_ended",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        component: str,
        trace_id: str,
        parent_id: str | None,
        attrs: dict,
        t0: float | None = None,
    ) -> None:
        self.tracer = tracer
        self.name = name
        self.component = component
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.attrs = attrs
        self.status = "ok"
        now_perf = time.perf_counter()
        # t0 backdates the start (e.g. the admit span spans queue wait
        # measured from submit time) without a second clock source.
        self._start_perf = now_perf if t0 is None else t0
        self._start_wall = time.time() - (now_perf - self._start_perf)
        self._dur: float | None = None
        self._token = None
        self._ended = False

    # --- mutation -------------------------------------------------------

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def context(self) -> SpanContext:
        return SpanContext(trace_id=self.trace_id, span_id=self.span_id)

    def end(self, status: str | None = None) -> None:
        if self._ended:
            return
        self._ended = True
        if status is not None:
            self.status = status
        self._dur = time.perf_counter() - self._start_perf
        self.tracer._finish(self)

    # --- context manager ------------------------------------------------

    def __enter__(self) -> "Span":
        self._token = _ACTIVE.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _ACTIVE.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
            self.end(status="error")
        else:
            self.end()
        return False

    def record(self) -> dict:
        """The canonical finished-span record (what the buffer stores)."""
        return {
            "name": self.name,
            "component": self.component,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_us": int(self._start_wall * 1e6),
            "dur_us": int((self._dur or 0.0) * 1e6),
            "status": self.status,
            "thread": threading.current_thread().name,
            "attrs": self.attrs,
        }


class _NoopSpan:
    """Shared do-nothing span: the disabled tracer hands out this ONE
    instance, so instrumentation costs no allocation when tracing is off."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = None
    name = ""
    component = ""
    status = "ok"
    attrs: dict = {}

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def context(self):
        return None

    def end(self, status: str | None = None) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Span factory + in-memory ring buffer of completed traces.

    Disabled (the default) it is inert: :meth:`span` returns the shared
    no-op span and hot paths guard on ``tracer.enabled`` (one attribute
    read). Enabled, finished spans collect per trace; when a trace's
    last open span ends, the whole trace moves to a bounded deque that
    ``GET /debug/traces`` and the exporter read."""

    def __init__(self, max_traces: int = 64,
                 max_spans_per_trace: int = 2048) -> None:
        self.enabled = False
        self.max_spans_per_trace = max_spans_per_trace
        # Live-table bound: a span leaked open (instrumented code died
        # without ending it) would pin its trace here forever; past this
        # many concurrently-live traces the OLDEST is evicted to the
        # finished ring marked incomplete, so memory stays bounded no
        # matter what the instrumented code does.
        self.max_live_traces = max(256, 4 * max_traces)
        self._lock = threading.Lock()
        # trace_id -> {"spans": [record...], "open": int, "dropped": int}
        self._live: dict[str, dict] = {}
        self._finished: deque[dict] = deque(maxlen=max_traces)
        self._listeners: list = []  # callables(record) on every span end

    # --- span creation --------------------------------------------------

    def span(self, name: str, component: str = "",
             parent=_FROM_CONTEXT, t0: float | None = None, **attrs):
        """Start a span (or the no-op when disabled). ``parent`` may be a
        Span, a SpanContext, None (force a new root), or absent (use the
        ambient context)."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is _FROM_CONTEXT:
            parent = _ACTIVE.get()
        if isinstance(parent, _NoopSpan):
            parent = None
        if parent is None:
            trace_id, parent_id = new_trace_id(), None
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        span = Span(self, name, component, trace_id, parent_id, attrs, t0=t0)
        with self._lock:
            entry = self._live.get(trace_id)
            if entry is None:
                while len(self._live) >= self.max_live_traces:
                    # evict the oldest live trace (dict = insertion
                    # order) as incomplete rather than grow unboundedly
                    old_id = next(iter(self._live))
                    old = self._live.pop(old_id)
                    self._finished.append({
                        "trace_id": old_id,
                        "spans": old["spans"],
                        "dropped": old["dropped"],
                        "incomplete": True,
                    })
                entry = {"spans": [], "open": 0, "dropped": 0}
                self._live[trace_id] = entry
            entry["open"] += 1
        return span

    def _finish(self, span: Span) -> None:
        record = span.record()
        finished_trace = None
        with self._lock:
            entry = self._live.get(span.trace_id)
            if entry is not None:
                if len(entry["spans"]) < self.max_spans_per_trace:
                    entry["spans"].append(record)
                else:
                    entry["dropped"] += 1
                entry["open"] -= 1
                if entry["open"] <= 0:
                    del self._live[span.trace_id]
                    finished_trace = {
                        "trace_id": span.trace_id,
                        "spans": entry["spans"],
                        "dropped": entry["dropped"],
                    }
                    self._finished.append(finished_trace)
        for listener in list(self._listeners):
            try:
                listener(record)
            except Exception:  # noqa: BLE001 - listeners must not break traced code
                pass

    # --- listeners (the metrics bridge) ---------------------------------

    def add_listener(self, fn) -> None:
        self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with contextlib.suppress(ValueError):
            self._listeners.remove(fn)

    # --- buffer reads ---------------------------------------------------

    def traces(self) -> list[dict]:
        """Newest-first summaries of completed traces."""
        with self._lock:
            snapshot = list(self._finished)
        out = []
        for trace in reversed(snapshot):
            spans = trace["spans"]
            roots = [s for s in spans if s["parent_id"] is None]
            root = roots[0] if roots else (spans[0] if spans else None)
            start = min((s["start_us"] for s in spans), default=0)
            end = max((s["start_us"] + s["dur_us"] for s in spans), default=0)
            out.append({
                "trace_id": trace["trace_id"],
                "root": root["name"] if root else "",
                "component": root["component"] if root else "",
                "start_us": start,
                "duration_ms": round((end - start) / 1000.0, 3),
                "n_spans": len(spans),
                "dropped_spans": trace["dropped"],
                "incomplete": trace.get("incomplete", False),
                "status": (
                    "error"
                    if any(s["status"] == "error" for s in spans) else "ok"
                ),
            })
        return out

    def get_trace(self, trace_id: str) -> list[dict] | None:
        """All span records of one completed (or still-live) trace."""
        with self._lock:
            for trace in self._finished:
                if trace["trace_id"] == trace_id:
                    return list(trace["spans"])
            entry = self._live.get(trace_id)
            if entry is not None:
                return list(entry["spans"])
        return None

    def clear(self) -> None:
        with self._lock:
            self._live.clear()
            self._finished.clear()


# --- ambient context helpers ----------------------------------------------


def current_context() -> "Span | SpanContext | None":
    """The active span (or remote context) for THIS task/thread context;
    capture it before handing work to another thread."""
    return _ACTIVE.get()


def current_trace_ids() -> tuple[str, str] | None:
    """(trace_id, span_id) of the active span, or None. The log
    injection hook: one ContextVar read when no span is active."""
    active = _ACTIVE.get()
    if active is None:
        return None
    return active.trace_id, active.span_id


@contextlib.contextmanager
def attach(parent: "Span | SpanContext | None"):
    """Restore a captured context on the current thread/task: spans
    started inside become children of ``parent``."""
    token = _ACTIVE.set(parent)
    try:
        yield parent
    finally:
        _ACTIVE.reset(token)


# --- process-global tracer -------------------------------------------------

_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer every instrumentation site shares."""
    return _TRACER


def configure(enabled: bool | None = None, max_traces: int | None = None,
              max_spans_per_trace: int | None = None) -> Tracer:
    """Reconfigure the global tracer (the serving CLI, tests)."""
    if max_traces is not None:
        with _TRACER._lock:
            _TRACER._finished = deque(_TRACER._finished, maxlen=max_traces)
    if max_spans_per_trace is not None:
        _TRACER.max_spans_per_trace = max_spans_per_trace
    if enabled is not None:
        _TRACER.enabled = enabled
    return _TRACER
