"""Span-duration histograms: the metrics leg of correlation.

The port's copy of ``k8s_gpu_device_plugin_tpu/obs/prom.py`` on the
port's own registry (``metrics/exposition.py``): a tracer end-of-span
listener feeding one histogram labelled (component, operation), the
same names the trace tree and the log records carry. The tracer never
imports this module; the serving CLI installs it under ``--tracing``.
"""

from __future__ import annotations

from k8s_gpu_device_plugin_torch.metrics.exposition import Histogram

# Spans range from sub-ms decode steps to multi-minute runs.
_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, float("inf"),
)


class SpanMetrics:
    """Registers once on ``registry``; driven by a Tracer listener. Call
    :meth:`close` before building a replacement on the same registry."""

    def __init__(self, registry, prefix: str = "gpu_obs"):
        self._registry = registry
        self._tracer = None
        self.span_seconds = Histogram(
            f"{prefix}_span_duration_seconds",
            "Duration of completed trace spans",
            ["component", "operation"],
            buckets=_BUCKETS,
            registry=registry,
        )

    def install(self, tracer) -> "SpanMetrics":
        """Subscribe to ``tracer``'s span-end stream."""
        self._tracer = tracer
        tracer.add_listener(self.observe)
        return self

    def observe(self, record: dict) -> None:
        self.span_seconds.labels(
            component=record.get("component") or "default",
            operation=record.get("name") or "unknown",
        ).observe(record.get("dur_us", 0) / 1e6)

    def close(self) -> None:
        """Detach from the tracer and unregister the histogram."""
        if self._tracer is not None:
            self._tracer.remove_listener(self.observe)
            self._tracer = None
        try:
            self._registry.unregister(self.span_seconds)
        except KeyError:
            pass  # already unregistered
