"""Fleet observability plane: the router-level half of obs/.

Port of ``k8s_gpu_device_plugin_tpu/obs/fleet_obs.py``: the pure
(HTTP-free) logic of the replica router's (``serving/router.py``)
observability, with the I/O in the router, the split ``obs/http.py``
keeps for the per-replica planes:

- **Fleet event journal** (:class:`FleetEventJournal`): a bounded ring
  of structured, monotonically-sequenced fleet operations. Events carry
  the ambient ``trace_id`` so an operator pivots from a journal entry to
  its trace; :meth:`FleetEventJournal.replay` strips the two
  nondeterministic fields (wall time, trace id), so two same-seed chaos
  runs produce IDENTICAL replay journals.
- **Failover-aware request timelines** (:class:`RouterTimeline`): the
  router-side twin of obs/attribution.py. One cursor advances through
  route -> relay:<replica> -> resume_gap -> relay:<replica'> segments
  (``transfer_gap`` across a disaggregated KV hop) held as integer
  nanoseconds, so the segments sum EXACTLY (±0, integer telescoping) to
  the client-observed wall time at the router seam.
- **The flight recorder** (:class:`RouterFlightRecorder`): every
  stream's record in a recent ring; resumed / failed-over /
  error-framed / SLO-breaching streams retained in their own.

The event kinds and their fields (``seq``, ``kind``, ``t``,
``trace_id`` on every event; the router emits exactly these):

=========================  ============================================
``failover``               ``path``, ``prev``, ``replica``, ``attempt``
``cooldown_429``           ``replica``, ``retry_after_s``
``drain``                  ``replica``
``drain_done``             ``replica``, ``drained``
``drain_refused``          ``replica``, ``reason`` (``role_empty``)
``undrain``                ``replica``
``promote``                ``promoted``, ``replaced``
``stream_resume``          ``source``, ``target`` (None with
                           ``synthesized_done``), ``tokens_at_death``
``budget_exhausted``       ``replica``, ``tokens_at_death``
``resume_failed``          ``replica`` (None after a failed KV
                           transfer), ``tokens_at_death``
``kv_transfer``            ``source``, ``target``, ``outcome`` (``ok`` /
                           ``fallback``), ``pages`` (ok only),
                           ``tokens_at_transfer``
``rolling_restart``        ``replicas``
``rolling_drain``          ``replica``
``rolling_undrain``        ``replica``, ``drained``
``rolling_restart_done``   ``completed``
=========================  ============================================

- **Cross-replica trace stitching** (:func:`spans_from_chrome`,
  :func:`stitch_spans`, :func:`stitched_trace_payload`; ``GET
  /fleet/debug/traces/{id}``): span fragments fetched from every
  replica's ``/debug/traces/{id}`` (plus the router's own ring) merge —
  deduplicated by span id, because an in-process fleet shares one
  process-global tracer — into one trace keyed by the propagated W3C
  ``traceparent`` trace id. Track assignment is transitive: a
  ``router_http`` span anchors the router track, a span carrying a
  ``replica`` attribute (the serving HTTP middleware stamps one) anchors
  its subtree to that replica's track, anything else inherits from its
  parent, falling back to the fragment it came from.
  :func:`obs.export.to_fleet_chrome_trace` renders the result as ONE
  Perfetto file with one process row per track.
- **Federated metrics** (:func:`federate_metrics`; ``GET
  /fleet/metrics``): each replica's ``/metrics`` exposition is
  re-labeled with ``replica="<id>"`` (escape-aware — label values pass
  through verbatim, OpenMetrics exemplars preserved untouched) and
  regrouped by metric family so the merged text stays PARSEABLE under
  both content types. Fleet aggregates ride along: ``gpu_fleet_mfu_pct``
  / ``gpu_fleet_hbm_bw_util_pct`` weight each replica's busy-window
  gauge by its ``tokens_per_second`` window (an idle replica, whose
  gauges zero on idle, weighs zero), and fleet-wide TTFT / inter-token
  histograms summed bucket-wise. The device plugin's scrapes (the
  reference's ``plugin_scrapes``, ``tpu_plugin_*`` chip aggregates) wait
  for the plugin's families: they are refused naming ROADMAP A.14.

Cost discipline: the journal writes only on failure/control-plane
paths, never per relayed byte (rare kinds additionally ride a
protected ring so request-rate failover/429 noise cannot evict them);
the timeline layer is optional (``timelines=False`` leaves the proxy
hot path with ``is not None`` guards).

Thread model: everything here is single-writer state owned by the
router's event loop (the router is single-threaded asyncio); handlers
read through the ``*_payload()``/``*_stats()`` snapshot methods.
"""

from __future__ import annotations

import time
from collections import deque

from k8s_gpu_device_plugin_torch.obs.export import to_fleet_chrome_trace
from k8s_gpu_device_plugin_torch.obs.trace import current_trace_ids

#: what the refused device-plugin federation names
PLUGINS_ITEM = "ROADMAP A.14"


# --- cross-replica trace stitching -----------------------------------------


def spans_from_chrome(payload: dict) -> list[dict]:
    """Chrome/Perfetto trace JSON (a replica's ``/debug/traces/{id}``
    answer) -> span records (the Tracer ring's native shape). The
    exporter is lossless for everything the stitcher needs — ids,
    parentage, timing, component, attrs — so fragments from remote
    replicas and the router's own ring merge as one species."""
    spans: list[dict] = []
    for evt in payload.get("traceEvents", ()):
        if evt.get("ph") != "X":
            continue  # metadata (thread_name) rows carry no span
        args = dict(evt.get("args") or {})
        span = {
            "name": evt.get("name", ""),
            "component": evt.get("cat") or "default",
            "trace_id": args.pop("trace_id", ""),
            "span_id": args.pop("span_id", ""),
            "parent_id": args.pop("parent_id", None),
            "start_us": int(evt.get("ts", 0)),
            "dur_us": int(evt.get("dur", 0)),
            "status": args.pop("status", "ok"),
            "thread": args.pop("thread", ""),
            "attrs": args,
        }
        spans.append(span)
    return spans


def stitch_spans(
    fragments: "list[tuple[str, list[dict]]]",
) -> tuple["list[tuple[str, list[dict]]]", dict]:
    """Merge per-source span fragments into per-track span lists.

    ``fragments`` is ``[(source_id, spans), ...]`` — ``source_id`` is
    the replica id the fragment was fetched from (or ``"router"``).
    Returns ``(tracks, summary)`` where ``tracks`` is an ordered
    ``[(track_id, spans)]`` and ``summary`` reports the merge:
    per-source fetched counts, per-track assigned counts, duplicates
    deduped, id-less spans DROPPED (unmergeable — counted as loss, not
    as duplication), and ORPHAN fragments (spans naming a parent id
    present in no fragment — a stitch that lost a replica's ring shows
    up here instead of rendering a silently partial trace).

    Dedup first (span_id; an in-process fleet shares one process-global
    tracer, so every source returns every span), then assign each span
    a track: its own ``replica`` attr wins; ``router_http`` spans
    anchor the ``router`` track; otherwise the span inherits its
    parent's track (the replica that served a request owns the
    request's whole subtree); a parentless, unattributed span falls
    back to the source it came from."""
    by_id: dict[str, tuple[str, dict]] = {}
    fetched: dict[str, int] = {}
    deduped = 0
    dropped = 0
    for source, spans in fragments:
        fetched[source] = fetched.get(source, 0) + len(spans)
        for span in spans:
            sid = span.get("span_id", "")
            if not sid:
                # a span with no id cannot be merged or parented: LOST,
                # and reported as such — not miscounted as a duplicate
                dropped += 1
            elif sid not in by_id:
                by_id[sid] = (source, span)
            else:
                deduped += 1

    assignment: dict[str, str] = {}
    orphans: list[str] = []

    def assign(sid: str, seen: set) -> str:
        cached = assignment.get(sid)
        if cached is not None:
            return cached
        source, span = by_id[sid]
        attrs = span.get("attrs") or {}
        track = None
        if span.get("component") == "router_http":
            # checked BEFORE the replica attr: a router span's
            # ``replica`` attribute names the replica it ROUTED TO
            # (the routing-decision attrs), not where it ran
            track = "router"
        elif attrs.get("replica"):
            track = str(attrs["replica"])
        else:
            parent = span.get("parent_id")
            if parent and parent in by_id and sid not in seen:
                track = assign(parent, seen | {sid})
        if track is None:
            track = source
        assignment[sid] = track
        return track

    for sid, (_, span) in by_id.items():
        assign(sid, set())
        parent = span.get("parent_id")
        if parent and parent not in by_id:
            orphans.append(sid)

    # deterministic track order: router first, then replicas in the
    # order their fragments were offered, then any stragglers
    order: list[str] = []
    if "router" in assignment.values():
        order.append("router")
    for source, _ in fragments:
        if source not in order and source in assignment.values():
            order.append(source)
    for track in assignment.values():
        if track not in order:
            order.append(track)

    tracks = [
        (track,
         sorted((s for sid, (_, s) in by_id.items()
                 if assignment[sid] == track),
                key=lambda s: s["start_us"]))
        for track in order
    ]
    trace_ids = {s.get("trace_id") for _, s in by_id.values()}
    summary = {
        "trace_id": next(iter(trace_ids)) if len(trace_ids) == 1 else None,
        "n_spans": len(by_id),
        "sources": fetched,
        "tracks": {t: len(spans) for t, spans in tracks},
        "deduped": deduped,
        "dropped": dropped,
        "orphans": sorted(orphans),
    }
    return tracks, summary


def stitched_trace_payload(
    fragments: "list[tuple[str, list[dict]]]",
) -> "dict | None":
    """``GET /fleet/debug/traces/{id}``: one Perfetto-openable document
    (one process row per replica + the router) with the stitch summary
    under a ``fleet`` key Perfetto ignores. ``None`` when no fragment
    held the trace (the handler answers 404)."""
    tracks, summary = stitch_spans(fragments)
    if not summary["n_spans"]:
        return None
    payload = to_fleet_chrome_trace(tracks)
    payload["fleet"] = summary
    return payload


# --- federated metrics -----------------------------------------------------

#: per-replica series feeding the fleet aggregates
#: (``metrics/serving_metrics.py``)
_MFU_GAUGE = "gpu_serving_mfu_pct"
_BW_GAUGE = "gpu_serving_hbm_bw_util_pct"
_TPS_GAUGE = "gpu_serving_tokens_per_second"
_AGG_HISTOGRAMS = (
    # (per-replica family, fleet family, help)
    ("gpu_serving_ttft_seconds", "gpu_fleet_ttft_seconds",
     "Fleet-wide time to first token (per-replica histograms summed "
     "bucket-wise)"),
    ("gpu_serving_inter_token_seconds", "gpu_fleet_inter_token_seconds",
     "Fleet-wide inter-token gap (per-replica histograms summed "
     "bucket-wise)"),
)


def _escape_label_value(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _split_sample(line: str) -> "tuple[str, str | None, str] | None":
    """One exposition sample line -> (name, labels-or-None, rest).

    ``rest`` starts at the character after the label set (or after the
    name) and carries the value plus anything behind it — timestamps,
    OpenMetrics exemplars — verbatim, which is how exemplars survive
    federation byte-exact. The label scan is escape-aware: a ``}``
    inside a quoted label value does not end the set."""
    brace = line.find("{")
    space = line.find(" ")
    if brace != -1 and (space == -1 or brace < space):
        name = line[:brace]
        i = brace + 1
        in_quote = False
        escaped = False
        while i < len(line):
            ch = line[i]
            if escaped:
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == '"':
                in_quote = not in_quote
            elif ch == "}" and not in_quote:
                return name, line[brace + 1:i], line[i + 1:]
            i += 1
        return None  # unterminated label set: not a sample line
    if space == -1:
        return None
    return line[:space], None, line[space:]


def _relabel(line: str, replica: str) -> str:
    """Prefix the sample's label set with ``replica="<replica>"``."""
    parts = _split_sample(line)
    if parts is None:
        return line
    name, labels, rest = parts
    tag = f'replica="{_escape_label_value(replica)}"'
    merged = f"{tag},{labels}" if labels else tag
    return f"{name}{{{merged}}}{rest}"


def _parse_labels(labels: "str | None") -> dict:
    out: dict[str, str] = {}
    if not labels:
        return out
    i = 0
    n = len(labels)
    while i < n:
        eq = labels.find("=", i)
        if eq == -1:
            break
        key = labels[i:eq].strip().lstrip(",").strip()
        j = labels.find('"', eq)
        if j == -1:
            break
        j += 1
        buf = []
        escaped = False
        while j < n:
            ch = labels[j]
            if escaped:
                buf.append({"n": "\n"}.get(ch, ch))
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == '"':
                break
            else:
                buf.append(ch)
            j += 1
        out[key] = "".join(buf)
        i = j + 1
    return out


def _sample_value(rest: str) -> "float | None":
    token = rest.strip().split(" ")[0] if rest.strip() else ""
    try:
        return float(token)
    except ValueError:
        return None


def _fmt(value: float) -> str:
    return repr(float(value))


class _Family:
    __slots__ = ("name", "meta", "samples")

    def __init__(self, name: str):
        self.name = name
        self.meta: list[str] = []   # first-seen HELP/TYPE/UNIT lines
        self.samples: list[str] = []


def _classic_to_om(text: str) -> str:
    """Make a CLASSIC-format exposition mergeable into an OpenMetrics
    document (the device plugin's /metrics serves classic only):
    counter families lose the ``_total`` suffix from their HELP/TYPE
    metadata — OpenMetrics names the family bare while the samples keep
    ``_total`` — and the ``*_created`` pseudo-families classic renders
    for creation timestamps are dropped, since OpenMetrics reserves
    that suffix INSIDE the real family and a second family with the
    name fails the strict parser. Its caller is the device plugin's
    federation (ROADMAP A.14)."""
    counters = set()
    for line in text.splitlines():
        parts = line.split(None, 3)
        if (len(parts) >= 4 and parts[0] == "#" and parts[1] == "TYPE"
                and parts[3].strip() == "counter"
                and parts[2].endswith("_total")):
            counters.add(parts[2])
    out: list[str] = []
    in_created = False
    for raw in text.splitlines():
        line = raw.rstrip("\r")
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE", "UNIT"):
                in_created = parts[2].endswith("_created")
                if in_created:
                    continue
                if parts[2] in counters:
                    parts[2] = parts[2][: -len("_total")]
                    line = " ".join(parts)
            out.append(line)
            continue
        if in_created:
            continue  # sample lines of a dropped _created family
        out.append(line)
    return "\n".join(out) + "\n"


def federate_metrics(
    scrapes: "list[tuple[str, str]]",
    *,
    openmetrics: bool = False,
    scrape_errors: "list[str] | None" = None,
    plugin_scrapes: "list[tuple[str, str]] | None" = None,
    plugin_scrape_errors: "list[str] | None" = None,
) -> str:
    """Merge replica expositions into ONE parseable fleet exposition.

    ``scrapes`` is ``[(replica_id, exposition_text), ...]``. Every
    sample line gains a leading ``replica="<id>"`` label; HELP/TYPE
    (/UNIT) metadata is kept once per family (first replica wins — the
    fleet runs one build, so they agree) and each family's samples stay
    contiguous across replicas, which is what keeps the merged text
    valid under the STRICT OpenMetrics parser (interleaved family
    blocks are not). The fleet-aggregate block appends at the end;
    ``scrape_errors`` (unreachable replicas) surface as a gauge so a
    partial federation pass is visible, not silent.

    ``plugin_scrapes`` / ``plugin_scrape_errors`` (the device plugins'
    ``/metrics``, federated under ``node=``) raise naming ROADMAP A.14:
    their families come with the device plugin."""
    if plugin_scrapes is not None or plugin_scrape_errors is not None:
        raise NotImplementedError(
            "device-plugin metrics federation needs the device plugin's "
            f"families, which are not ported yet ({PLUGINS_ITEM})"
        )
    families: dict[str, _Family] = {}
    # per-replica parsed values for the aggregates
    mfu: list[tuple[float, float, float]] = []  # (mfu, bw, weight)
    hist: dict[str, dict] = {
        fam: {"buckets": {}, "order": [], "sum": 0.0, "count": 0.0,
              "seen": False}
        for fam, _, _ in _AGG_HISTOGRAMS
    }

    def ingest(identity: str, text: str, on_sample) -> None:
        current: "_Family | None" = None
        fresh: set[str] = set()  # families THIS scrape introduced
        for raw in text.splitlines():
            line = raw.rstrip("\r")
            if not line.strip():
                continue
            if line.startswith("#"):
                parts = line.split(None, 3)
                if len(parts) >= 3 and parts[1] in ("HELP", "TYPE", "UNIT"):
                    fam = families.get(parts[2])
                    if fam is None:
                        fam = families[parts[2]] = _Family(parts[2])
                        fresh.add(parts[2])
                    if parts[2] in fresh:
                        # first scrape naming a family defines its
                        # metadata; later scrapes repeat it (one build
                        # fleet-wide) and a second copy would be
                        # invalid OpenMetrics
                        fam.meta.append(line)
                    current = fam
                continue  # `# EOF` / stray comments: re-emitted at the end
            parsed = _split_sample(line)
            if parsed is None:
                continue
            name, labels, rest = parsed
            if current is None or not name.startswith(current.name):
                current = families.get(name)
                if current is None:
                    current = families[name] = _Family(name)
            current.samples.append(_relabel(line, identity))
            value = _sample_value(rest)
            if value is None:
                continue
            on_sample(name, labels, value)

    for replica, text in scrapes:
        vals: dict[str, float] = {}

        def on_serving_sample(name, labels, value, vals=vals):
            if name in (_MFU_GAUGE, _BW_GAUGE, _TPS_GAUGE):
                vals[name] = value
            for fam, _, _ in _AGG_HISTOGRAMS:
                if not name.startswith(fam):
                    continue
                h = hist[fam]
                if name == f"{fam}_bucket":
                    le = _parse_labels(labels).get("le")
                    if le is not None:
                        if le not in h["buckets"]:
                            h["buckets"][le] = 0.0
                            h["order"].append(le)
                        h["buckets"][le] += value
                        h["seen"] = True
                elif name == f"{fam}_sum":
                    h["sum"] += value
                elif name == f"{fam}_count":
                    h["count"] += value

        ingest(replica, text, on_serving_sample)
        if _MFU_GAUGE in vals:
            mfu.append((
                vals.get(_MFU_GAUGE, 0.0),
                vals.get(_BW_GAUGE, 0.0),
                max(0.0, vals.get(_TPS_GAUGE, 0.0)),
            ))

    out: list[str] = []
    for fam in families.values():
        out.extend(fam.meta)
        out.extend(fam.samples)

    # --- the fleet-aggregate block ---
    def gauge(name: str, help_: str, value: float) -> None:
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} gauge")
        out.append(f"{name} {_fmt(value)}")

    gauge("gpu_fleet_replicas", "Replicas merged into this federation pass",
          len(scrapes))
    gauge("gpu_fleet_scrape_errors",
          "Replicas whose /metrics scrape failed this pass",
          len(scrape_errors or ()))
    weight_total = sum(w for _, _, w in mfu)
    gauge(
        "gpu_fleet_mfu_pct",
        "Fleet model-FLOPs utilization: per-replica busy-window gauges "
        "weighted by each replica's tokens_per_second window (idle "
        "replicas weigh zero)",
        sum(m * w for m, _, w in mfu) / weight_total if weight_total else 0.0,
    )
    gauge(
        "gpu_fleet_hbm_bw_util_pct",
        "Fleet HBM-roofline bandwidth utilization, busy-window weighted "
        "like gpu_fleet_mfu_pct",
        sum(b * w for _, b, w in mfu) / weight_total if weight_total else 0.0,
    )
    for fam, fleet_fam, help_ in _AGG_HISTOGRAMS:
        h = hist[fam]
        if not h["seen"]:
            continue
        out.append(f"# HELP {fleet_fam} {help_}")
        out.append(f"# TYPE {fleet_fam} histogram")
        for le in h["order"]:
            out.append(
                f'{fleet_fam}_bucket{{le="{le}"}} {_fmt(h["buckets"][le])}'
            )
        out.append(f"{fleet_fam}_count {_fmt(h['count'])}")
        out.append(f"{fleet_fam}_sum {_fmt(h['sum'])}")
    if openmetrics:
        out.append("# EOF")
    return "\n".join(out) + "\n"


# --- fleet event journal ---------------------------------------------------

class FleetEventJournal:
    """Bounded engine-of-record ring of fleet operations.

    Single writer (the router's event loop); every event gets the next
    monotonic ``seq`` and the ambient trace id (so a journal entry
    links to its stitched trace). ``?since=<seq>``/``?limit=`` page the
    ring forward — the incremental-poll idiom the trace planes use,
    through the same ``obs/http.parse_trace_query`` rule.

    Retention is two-tier, the flight recorder's stance: ``failover``
    and ``cooldown_429`` fire once per affected REQUEST, so an overload
    storm emits them at request rate — left unchecked they would churn
    the ring and evict exactly the rare control-plane history (promote,
    drain, stream_resume) an operator reaches for minutes later. Rare
    kinds are therefore ALSO kept in their own ring that per-request
    noise cannot touch; :meth:`events_payload` merges the two by seq,
    so the surface stays one ordered journal.

    Determinism contract: under the seeded fault plane, the SEQUENCE of
    (seq, kind, deterministic fields) is identical across same-seed
    runs; only the wall timestamp and the (random) trace id vary.
    :meth:`replay` strips exactly those two fields — the determinism tests
    compare replays, not raw events."""

    #: fields excluded from the determinism comparison: wall time and
    #: the (secrets-random) trace id
    NONDETERMINISTIC_FIELDS = ("t", "trace_id")

    #: kinds emitted once per affected request (failure-path, but
    #: request-rate under an overload storm); every other kind is a
    #: rare control-plane event and rides the protected ring too
    FREQUENT_KINDS = frozenset({"failover", "cooldown_429"})

    def __init__(self, maxlen: int = 1024, rare_maxlen: int = 256):
        self._events: deque[dict] = deque(maxlen=maxlen)  # owner: engine
        self._rare: deque[dict] = deque(maxlen=rare_maxlen)  # owner: engine
        self._seq = 0                                     # owner: engine

    def emit(self, kind: str, **fields) -> dict:
        self._seq += 1
        ids = current_trace_ids()
        event = {
            "seq": self._seq,
            "kind": kind,
            "t": round(time.time(), 6),
            "trace_id": ids[0] if ids is not None else "",
            **fields,
        }
        self._events.append(event)
        if kind not in self.FREQUENT_KINDS:
            self._rare.append(event)
        return event

    # --- snapshots --------------------------------------------------------

    def events_payload(self, limit: "int | None" = None,
                       since: "int | None" = None) -> dict:
        """``GET /fleet/events``: oldest-first (replay order), ``since``
        returns only events with ``seq > since`` (a poller passes the
        last seq it saw), ``limit`` caps the page at its OLDEST entries
        so consecutive polls page deterministically forward. ``total``
        counts every event ever emitted — a gap between ``since`` and
        the first returned seq means the ring evicted the interval."""
        merged: dict[int, dict] = {}
        for ring in (self._rare, self._events):
            for e in ring:
                if since is None or e["seq"] > since:
                    merged[e["seq"]] = e
        seqs = sorted(merged)
        if limit is not None:
            seqs = seqs[:limit]
        # copy only the returned page (a ?since= poller's steady-state
        # page is empty; the rings can hold ~1k entries)
        events = [dict(merged[seq]) for seq in seqs]
        return {
            "total": self._seq,
            "returned": len(events),
            "events": events,
        }

    @staticmethod
    def replay(events: "list[dict]") -> list[dict]:
        """The deterministic view: events minus wall time + trace id.
        Two same-seed chaos runs must produce EQUAL replays."""
        return [
            {k: v for k, v in e.items()
             if k not in FleetEventJournal.NONDETERMINISTIC_FIELDS}
            for e in events
        ]

    def stats(self) -> dict:
        merged = {e["seq"] for e in self._events}
        merged.update(e["seq"] for e in self._rare)
        return {"emitted": self._seq, "resident": len(merged)}


# --- failover-aware request timelines --------------------------------------

class RouterTimeline:
    """One proxied request's router-side phase timeline.

    obs/attribution.py's cursor discipline at the router seam, with one
    upgrade: the cursor is INTEGER nanoseconds (``perf_counter_ns``), so the
    phase segments sum to the client-observed wall time exactly — ±0
    by integer telescoping, not approximately within float rounding.
    Phases: ``route`` (candidate scan: ring walk, bounded-load spill,
    connect attempts, 429 cooldown hops), ``relay:<replica>`` (bytes
    flowing from that replica), ``resume_gap`` (a mid-stream death
    until the continuation's first relay — the window a client
    perceives as a stall), repeating across chained deaths."""

    __slots__ = (
        "rid", "path", "trace_id", "t0_ns", "t_wall", "stage", "cursor_ns",
        "segments", "replicas", "resumes", "failovers", "affinity_hit",
        "tokens", "error_code",
    )

    def __init__(self, rid: int, path: str, trace_id: str = "",
                 t0_ns: "int | None" = None):
        self.rid = rid
        self.path = path
        self.trace_id = trace_id
        self.t0_ns = time.perf_counter_ns() if t0_ns is None else t0_ns
        self.t_wall = time.time()
        self.stage = "route"
        self.cursor_ns = self.t0_ns
        self.segments: list[list] = []  # [stage, start_ns, dur_ns]
        self.replicas: list[str] = []   # relay order (dedup-adjacent)
        self.resumes = 0
        self.failovers = 0
        self.affinity_hit = False
        self.tokens = 0
        self.error_code: "str | None" = None  # structured-error-frame code

    def advance(self, stage: str, now_ns: "int | None" = None) -> None:
        now = time.perf_counter_ns() if now_ns is None else now_ns
        self.segments.append([
            self.stage, self.cursor_ns - self.t0_ns,
            max(0, now - self.cursor_ns),
        ])
        self.stage = stage
        self.cursor_ns = now

    def relay_on(self, replica: str) -> None:
        if not self.replicas or self.replicas[-1] != replica:
            self.replicas.append(replica)
        self.advance(f"relay:{replica}")

    def finalize(self, outcome: str, status: "int | None" = None) -> dict:
        now = time.perf_counter_ns()
        self.advance("done", now)
        total_ns = now - self.t0_ns
        phases: dict[str, int] = {}
        for name, _start, dur in self.segments:
            phases[name] = phases.get(name, 0) + dur
        return {
            "rid": self.rid,
            "path": self.path,
            "trace_id": self.trace_id,
            "outcome": outcome,
            "status": status,
            "t_submit_wall": round(self.t_wall, 6),
            "total_ns": total_ns,
            "total_s": round(total_ns / 1e9, 6),
            # integer ns so sum(dur) == total_ns EXACTLY (pinned)
            "segments": [list(s) for s in self.segments],
            "phases": phases,
            "replicas": list(self.replicas),
            "resumes": self.resumes,
            "failovers": self.failovers,
            "resume_gap_ns": phases.get("resume_gap", 0),
            "affinity_hit": self.affinity_hit,
            "tokens": self.tokens,
            "error_code": self.error_code,
        }


class RouterFlightRecorder:
    """Bounded retention for router timelines: every stream keeps a
    recent-ring summary; resumed / failed-over / error-framed /
    SLO-breaching streams are RETAINED in their own ring so the
    interesting tail outlives ordinary churn (obs/attribution.py's
    flight-recorder stance, one tier up)."""

    def __init__(self, recent: int = 256, ring: int = 128,
                 slow_ms: float = 0.0):
        self.slow_ms = float(slow_ms)
        self._recent: deque[dict] = deque(maxlen=recent)  # owner: engine
        self._ring: deque[dict] = deque(maxlen=ring)      # owner: engine
        self._next_rid = 0     # owner: engine
        self._n_done = 0       # owner: engine
        self._n_retained = 0   # owner: engine

    def start(self, path: str, trace_id: str = "") -> RouterTimeline:
        self._next_rid += 1
        return RouterTimeline(self._next_rid, path, trace_id)

    def on_done(self, record: dict) -> None:
        self._n_done += 1
        # retention keys on the stream's OWN story — it resumed, it
        # failed over, it ended with a structured error frame, or it
        # breached the SLO threshold. Ambient fleet conditions (429
        # overload storms, drain refusals, client disconnects) are
        # deliberately NOT retained: >ring of them would evict exactly
        # the resumed-stream tail this recorder exists to keep (those
        # streams still ride the recent ring and the refusal counters)
        keep = bool(
            record["resumes"]
            or record["failovers"]
            or record["error_code"]
            or (self.slow_ms > 0
                and record["total_ns"] >= self.slow_ms * 1e6)
        )
        if keep:
            record = dict(record, retained=True)
            self._ring.append(record)
            self._n_retained += 1
        self._recent.append(record)

    # --- snapshots --------------------------------------------------------

    def request_stats(self) -> dict:
        """``GET /fleet/debug/requests``: recent timelines newest-first
        plus the retained ring (resumed/failed-over/slow)."""
        return {
            "completed": self._n_done,
            "retained": self._n_retained,
            "slow_ms": self.slow_ms,
            "requests": [dict(r) for r in reversed(list(self._recent))],
            "retained_requests": [
                dict(r) for r in reversed(list(self._ring))
            ],
        }

    def get(self, rid: int) -> "dict | None":
        for r in reversed(list(self._ring)):
            if r["rid"] == rid:
                return dict(r)
        for r in reversed(list(self._recent)):
            if r["rid"] == rid:
                return dict(r)
        return None

    def resume_gap_ms(self) -> list[float]:
        """Resume-gap durations (ms) of the retained resumed streams —
        the resume-gap percentiles' source."""
        return [
            r["resume_gap_ns"] / 1e6
            for r in list(self._ring) if r["resumes"]
        ]

    def stats(self) -> dict:
        return {
            "completed": self._n_done,
            "retained": self._n_retained,
            "slow_ms": self.slow_ms,
        }
