"""A small Prometheus registry: labelled counters, gauges and histograms.

The reference's metrics (``metrics/serving_metrics.py``, ``obs/prom.py``)
sit on ``prometheus_client``, which the card's machine does not have, so
the port keeps its own: the three metric types with label children,
exemplars on histogram buckets, and two renderings of one registry:

- the classic text format 0.0.4 (``render(openmetrics=False)``): what a
  plain ``GET /metrics`` answers, exemplars left out;
- OpenMetrics 1.0.0 (``render(openmetrics=True)``), for a scraper that
  sends ``Accept: application/openmetrics-text``: counter families
  named without ``_total``, ``# {trace_id="..."} value timestamp``
  exemplars on the buckets that hold them, ``# EOF`` last.

Sample names, ``_created`` series and number formatting follow
``prometheus_client``'s, so both of its parsers read either rendering.

There is no process-global registry: each server owns one
(``Registry()``) and its families unregister when the server stops, so
a process may start and stop any number of servers. A label value with
a control character is refused (``ValueError``): the tenant label comes
from a request body, and a newline would forge exposition lines.

Thread-safe: the engine thread writes, HTTP threads render; each family
holds one lock over its children.
"""

from __future__ import annotations

import bisect
import math
import threading
import time

INF = float("inf")

#: the two renderings' ``Content-Type`` headers, and what a scraper's
#: ``Accept`` names to ask for OpenMetrics
CONTENT_TYPE_CLASSIC = "text/plain; version=0.0.4; charset=utf-8"
CONTENT_TYPE_OPENMETRICS = ("application/openmetrics-text; version=1.0.0; "
                            "charset=utf-8")
OPENMETRICS_ACCEPT = "application/openmetrics-text"


def _num(value: float) -> str:
    """``prometheus_client``'s Go-style float text (1.0, 0.001, +Inf,
    1e+09): the parsers hold ``le`` labels to it."""
    d = float(value)
    if d == INF:
        return "+Inf"
    if d == -INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(text: str, openmetrics: bool) -> str:
    text = text.replace("\\", r"\\").replace("\n", r"\n")
    return text.replace('"', r"\"") if openmetrics else text


def _label_str(pairs) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs) + "}"


class Registry:
    """One server's metric families, in registration order."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, "_Metric"] = {}

    def register(self, metric: "_Metric") -> None:
        with self._lock:
            if metric.name in self._families:
                raise ValueError(f"metric family {metric.name!r} is already "
                                 "registered")
            self._families[metric.name] = metric

    def unregister(self, metric: "_Metric") -> None:
        """KeyError when ``metric`` is not registered here."""
        with self._lock:
            if self._families.get(metric.name) is not metric:
                raise KeyError(metric.name)
            del self._families[metric.name]

    def families(self) -> list["_Metric"]:
        with self._lock:
            return list(self._families.values())

    def render(self, openmetrics: bool = False) -> str:
        lines: list[str] = []
        for metric in self.families():
            metric.render(lines, openmetrics)
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def get_sample_value(self, name: str,
                         labels: "dict | None" = None) -> "float | None":
        """The value of one sample of the classic rendering (``name``
        with its suffix: ``x_total``, ``x_bucket``...), None if absent."""
        want = dict(labels or {})
        for metric in self.families():
            for sname, pairs, value, _ in metric.samples():
                if sname == name and dict(pairs) == want:
                    return value
        return None


class _Metric:
    """A family: its name, help, type, label names and children (one per
    label-value tuple; the unlabelled family is its own only child)."""

    type = ""

    def __init__(self, name: str, documentation: str,
                 labelnames=(), registry: "Registry | None" = None) -> None:
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()
        if registry is not None:
            registry.register(self)

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values, **kw) -> "_Child":
        if kw:
            if values or set(kw) != set(self.labelnames):
                raise ValueError(f"{self.name}: labels {sorted(kw)} given, "
                                 f"{list(self.labelnames)} declared")
            values = tuple(kw[n] for n in self.labelnames)
        if len(values) != len(self.labelnames) or not self.labelnames:
            raise ValueError(f"{self.name}: {len(values)} label values for "
                             f"{list(self.labelnames)}")
        values = tuple(str(v) for v in values)
        for v in values:
            if not v.isprintable():
                raise ValueError(f"{self.name}: label value {v!r} holds a "
                                 "control character")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._new_child()
        return _Child(self, child)

    def _only(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}: "
                             "use .labels(...)")
        return self._children[()]

    def _snapshot(self) -> list[tuple]:
        with self._lock:
            return [(dict(zip(self.labelnames, k)), c.copy())
                    for k, c in self._children.items()]

    def samples(self):
        """(sample name, label pairs, value, exemplar) in the classic
        rendering's order; ``_created`` series last per child."""
        raise NotImplementedError

    def render(self, lines: list[str], openmetrics: bool) -> None:
        help_text = _escape_help(self.documentation, openmetrics)
        samples = list(self.samples())
        if openmetrics:
            # a counter family is named without _total; each child's
            # samples stay together (the parser's grouping rule)
            family = self.name[:-len("_total")] if self.type == "counter" \
                else self.name
            lines.append(f"# HELP {family} {help_text}")
            lines.append(f"# TYPE {family} {self.type}")
            lines.extend(_sample_line(s, True) for s in samples)
            return
        # classic: the _created series form a gauge family of their own
        created = [s for s in samples if s[0].endswith("_created")]
        lines.append(f"# HELP {self.name} {help_text}")
        lines.append(f"# TYPE {self.name} {self.type}")
        lines.extend(_sample_line(s, False) for s in samples
                     if not s[0].endswith("_created"))
        if created:
            lines.append(f"# HELP {created[0][0]} {help_text}")
            lines.append(f"# TYPE {created[0][0]} gauge")
            lines.extend(_sample_line(s, False) for s in created)


def _sample_line(sample: tuple, openmetrics: bool) -> str:
    name, pairs, value, exemplar = sample
    line = f"{name}{_label_str(pairs)} {_num(value)}"
    if openmetrics and exemplar is not None:
        ex_labels, ex_value, ex_ts = exemplar
        line += (f" # {_label_str(sorted(ex_labels.items()))} "
                 f"{_num(ex_value)} {ex_ts}")
    return line


class _Child:
    """One label-value tuple's handle: ``inc``, ``set``, ``observe``."""

    __slots__ = ("_metric", "_value")

    def __init__(self, metric: _Metric, value) -> None:
        self._metric = metric
        self._value = value

    def inc(self, amount: float = 1.0) -> None:
        self._metric._inc(self._value, amount)

    def set(self, value: float) -> None:
        self._metric._set(self._value, value)

    def observe(self, value: float, exemplar: "dict | None" = None) -> None:
        self._metric._observe(self._value, value, exemplar)


class _Scalar:
    __slots__ = ("value", "created")

    def __init__(self) -> None:
        self.value = 0.0
        self.created = time.time()

    def copy(self) -> "_Scalar":
        out = _Scalar.__new__(_Scalar)
        out.value, out.created = self.value, self.created
        return out


class Counter(_Metric):
    """A monotonic counter; ``name`` ends in ``_total`` on the wire."""

    type = "counter"

    def __init__(self, name: str, documentation: str, labelnames=(),
                 registry: "Registry | None" = None) -> None:
        if not name.endswith("_total"):
            name += "_total"
        super().__init__(name, documentation, labelnames, registry)

    def _new_child(self):
        return _Scalar()

    def _inc(self, child, amount: float) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up "
                             f"(inc by {amount})")
        with self._lock:
            child.value += amount

    def inc(self, amount: float = 1.0) -> None:
        self._inc(self._only(), amount)

    def samples(self):
        base = self.name[:-len("_total")]
        for labels, c in self._snapshot():
            pairs = sorted(labels.items())
            yield self.name, pairs, c.value, None
            yield base + "_created", pairs, c.created, None


class Gauge(_Metric):
    """A value that goes up and down."""

    type = "gauge"

    def _new_child(self):
        return _Scalar()

    def _set(self, child, value: float) -> None:
        with self._lock:
            child.value = float(value)

    def set(self, value: float) -> None:
        self._set(self._only(), value)

    def samples(self):
        for labels, c in self._snapshot():
            yield self.name, sorted(labels.items()), c.value, None


class _Buckets:
    __slots__ = ("counts", "sum", "exemplars", "created")

    def __init__(self, n: int) -> None:
        self.counts = [0] * n
        self.sum = 0.0
        self.exemplars: list = [None] * n
        self.created = time.time()

    def copy(self) -> "_Buckets":
        out = _Buckets.__new__(_Buckets)
        out.counts, out.sum = list(self.counts), self.sum
        out.exemplars, out.created = list(self.exemplars), self.created
        return out


class Histogram(_Metric):
    """Cumulative buckets (``+Inf`` appended when missing), the newest
    exemplar kept per bucket."""

    type = "histogram"

    def __init__(self, name: str, documentation: str, labelnames=(),
                 buckets=(), registry: "Registry | None" = None) -> None:
        bounds = [float(b) for b in buckets]
        if not bounds or bounds != sorted(bounds):
            raise ValueError(f"{name}: buckets must be given in order")
        if bounds[-1] != INF:
            bounds.append(INF)
        self.buckets = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry)

    def _new_child(self):
        return _Buckets(len(self.buckets))

    def _observe(self, child, value: float,
                 exemplar: "dict | None") -> None:
        i = bisect.bisect_left(self.buckets, value)
        if exemplar is not None:
            exemplar = ({str(k): str(v) for k, v in exemplar.items()},
                        float(value), time.time())
            if sum(len(k) + len(v) for k, v in exemplar[0].items()) > 128:
                raise ValueError(f"{self.name}: exemplar labels past 128 "
                                 "characters")
        with self._lock:
            child.counts[i] += 1
            child.sum += value
            if exemplar is not None:
                child.exemplars[i] = exemplar

    def observe(self, value: float, exemplar: "dict | None" = None) -> None:
        self._observe(self._only(), value, exemplar)

    def samples(self):
        for labels, c in self._snapshot():
            pairs = sorted(labels.items())
            total = 0
            for bound, count, ex in zip(self.buckets, c.counts, c.exemplars):
                total += count
                yield (self.name + "_bucket",
                       sorted([*pairs, ("le", _num(bound))]), float(total),
                       ex)
            yield self.name + "_count", pairs, float(total), None
            yield self.name + "_sum", pairs, c.sum, None
            yield self.name + "_created", pairs, c.created, None
