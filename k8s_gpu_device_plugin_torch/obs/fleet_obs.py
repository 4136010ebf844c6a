"""Fleet observability plane: the router-level half of obs/.

Port of the part of ``k8s_gpu_device_plugin_tpu/obs/fleet_obs.py`` that
the replica router (``serving/router.py``) writes on every request and
every fleet operation; the pure (HTTP-free) logic, with the I/O in the
router, the split ``obs/http.py`` keeps for the per-replica planes:

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

Not ported yet (ROADMAP A.10c2): metrics federation
(``federate_metrics``, ``GET /fleet/metrics``) and cross-replica trace
stitching (``spans_from_chrome``, ``stitch_spans``,
``stitched_trace_payload``, ``GET /fleet/debug/traces/{id}``).

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

from k8s_gpu_device_plugin_torch.obs.trace import current_trace_ids


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
