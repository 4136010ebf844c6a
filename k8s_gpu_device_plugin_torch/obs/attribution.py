"""Per-request latency attribution + the tail-latency flight recorder.

The port's copy of ``k8s_gpu_device_plugin_tpu/obs/attribution.py``
(the chip attribution of ``set_devices`` waits for the device plugin).
The spans (obs/trace.py) and aggregate histograms (ServingMetrics) say
*that* p99 TTFT regressed; this layer says *which phase* of *which
request* ate the time. Every retired request gets a structured timeline
composed from facts the batcher already owns — submit/admit marks, the
prefix match, page reservation, prefill chunks, per-token decode gaps,
speculative rounds, preemption cycles — partitioned into phases that
sum (exactly, by construction: one cursor advances through them) to the
request's measured wall time:

    queue_wait -> prefill -> decode     (repeating across preemptions)

The record is exported four ways: an opt-in field on the native/OpenAI
``done`` payloads, ``GET /debug/requests`` (+``/{rid}``), per-phase
Prometheus histograms with trace-id exemplars, and — for requests that
breach a latency threshold — the **flight recorder**: a bounded ring
(``GET /debug/slow``) that retains full step-level detail (per-token
gaps, per-chunk prefill timings) only for the outliers, so a tail spike
is explainable after the fact without paying for full detail on every
request.

Threading: one :class:`RequestAttributor` is owned by the batcher and
touched only on the engine thread (``# owner: engine`` on every ring);
HTTP readers go through the ``*_stats()`` snapshots, the same contract
as ``kv_stats``/``sched_stats``. Every hook runs on the host side of the
decode step (never inside the captured CUDA graph) and reads host
counts only: no device synchronisation.

Cost discipline: ``attribution=None`` (the default at the batcher
level) leaves the hot path with nothing but ``is not None`` checks,
pinned by the bit-identical stream tests; with attribution on,
per-token work is two float ops and a bounded append.
"""

from __future__ import annotations

import time
from collections import deque

#: per-request step-detail bound: decode gaps + prefill chunks kept per
#: timeline while the request is live (a 100k-token decode must not
#: grow an unbounded list; the newest detail is the useful tail)
MAX_STEP_DETAIL = 2048


class RequestTimeline:
    """One request's in-flight attribution state (engine-thread only;
    finalized into a plain dict at retirement)."""

    __slots__ = (
        "rid", "xid", "tenant", "priority", "t_submit", "t_submit_wall",
        "stage", "cursor", "segments", "prefix_match_s", "page_alloc_s",
        "prefill_chunks", "spec_rounds", "itl_count", "itl_sum", "itl_max",
        "steps", "record",
    )

    def __init__(self, rid: int, xid: str, tenant: str, priority: int,
                 t_submit: float) -> None:
        self.rid = rid
        self.xid = xid          # exemplar id: trace_id, or "rid:N" untraced
        self.tenant = tenant
        self.priority = priority
        self.t_submit = t_submit
        self.t_submit_wall = time.time() - (time.perf_counter() - t_submit)
        self.stage = "queue_wait"
        self.cursor = t_submit  # start of the CURRENT phase segment
        self.segments: list[list] = []  # [name, start_rel_s, dur_s]
        self.prefix_match_s = 0.0
        self.page_alloc_s = 0.0
        self.prefill_chunks = 0
        self.spec_rounds = 0
        self.itl_count = 0
        self.itl_sum = 0.0
        self.itl_max = 0.0
        # step-level detail: ("decode", rel_s, gap_s) per token and
        # ("prefill_chunk", rel_s, dispatch_s) per chunk — retained past
        # retirement only when the flight recorder keeps the request
        self.steps: deque = deque(maxlen=MAX_STEP_DETAIL)
        self.record: dict | None = None  # the finalized dict

    # --- engine-thread mutation -----------------------------------------

    def advance(self, stage: str, now: float) -> None:
        """Close the current phase segment at ``now`` and enter
        ``stage``. The cursor discipline is what makes the phase sums
        exact: every instant between submit and retirement belongs to
        exactly one segment."""
        self.segments.append([
            self.stage,
            self.cursor - self.t_submit,
            max(0.0, now - self.cursor),
        ])
        self.stage = stage
        self.cursor = now

    def add_itl(self, now: float, gap: float) -> None:
        self.itl_count += 1
        self.itl_sum += gap
        if gap > self.itl_max:
            self.itl_max = gap
        self.steps.append(("decode", now - self.t_submit, gap))

    def add_chunk(self, now: float, dur: float) -> None:
        self.prefill_chunks += 1
        self.steps.append(("prefill_chunk", now - self.t_submit, dur))


class RequestAttributor:
    """Engine-owned collector of retired-request timelines + the
    flight-recorder ring for tail outliers.

    Retention policy (decided at retirement, so collection stays cheap
    and uniform): a request is SLOW — full step detail retained on
    ``GET /debug/slow`` — when any of

    - ``slow_ms`` > 0 and its total wall time reaches it,
    - it missed its deadline (the scheduler's own definition), or
    - automatic p99-of-window triggering — armed only when ``slow_ms``
      is 0 (untuned): with >= ``window_min`` retirements in the
      sliding window, its total reaches the window's p99
      (nearest-rank). An operator who DID set a threshold gets exactly
      that threshold (plus deadline misses), not a ring churned by the
      top 1% of ordinary traffic.
    """

    def __init__(self, slow_ms: float = 0.0, recent: int = 256,
                 slow_ring: int = 64, window: int = 256,
                 window_min: int = 32, metrics=None):
        self.slow_ms = float(slow_ms)
        self.metrics = metrics
        self._recent: deque = deque(maxlen=recent)   # owner: engine
        self._slow_ring: deque = deque(maxlen=slow_ring)  # owner: engine
        self._lat_window: deque = deque(maxlen=window)  # owner: engine
        self.window_min = int(window_min)
        self._n_retired = 0   # owner: engine
        self._n_slow = 0      # owner: engine

    def set_devices(self, devices) -> None:
        """The reference stamps each retired record with the chips that
        served it; the port has no device allocation to name yet (ROADMAP
        A.14), so this is a no-op."""

    # --- batcher hooks (engine thread) -----------------------------------

    def start(self, req, trace_id: str = "") -> RequestTimeline:
        return RequestTimeline(
            req.rid, trace_id or f"rid:{req.rid}", req.tenant, req.priority,
            req.t_submit,
        )

    def window_p99_s(self) -> "float | None":
        if len(self._lat_window) < self.window_min:
            return None
        xs = sorted(self._lat_window)
        return xs[min(len(xs) - 1, int(round(0.99 * (len(xs) - 1))))]

    def on_retired(self, req, reason: str, now: float,
                   deadline_missed: bool = False) -> dict:
        """Finalize the request's timeline into a plain dict, observe
        the per-phase histograms (with exemplars), and decide slow-ring
        retention. Returns the record (also left on ``req.timeline``
        for the serving engine's done-payload export)."""
        tl: RequestTimeline = req.timeline
        tl.advance("done", now)
        total = now - tl.t_submit
        phases: dict[str, float] = {}
        for name, _start, dur in tl.segments:
            phases[name] = phases.get(name, 0.0) + dur
        ttft = (req.t_first_tok - tl.t_submit) if req.t_first_tok else None
        record = {
            "rid": tl.rid,
            "trace_id": tl.xid,
            "tenant": tl.tenant,
            "priority": tl.priority,
            "reason": reason,
            "t_submit_wall": round(tl.t_submit_wall, 6),
            "total_s": round(total, 6),
            "ttft_s": round(ttft, 6) if ttft is not None else None,
            "tokens": len(req.out),
            "prompt_tokens": len(req.prompt) - req.prefilled_out,
            "cached_tokens": req.cached_tokens,
            "preemptions": req.preemptions,
            "spec_rounds": tl.spec_rounds,
            "prefill_chunks": tl.prefill_chunks,
            "phases": {k: round(v, 6) for k, v in phases.items()},
            "segments": [
                [n, round(s, 6), round(d, 6)] for n, s, d in tl.segments
            ],
            "detail": {
                "prefix_match_s": round(tl.prefix_match_s, 6),
                "page_alloc_s": round(tl.page_alloc_s, 6),
                "itl": {
                    "count": tl.itl_count,
                    "mean_s": round(
                        tl.itl_sum / tl.itl_count, 6
                    ) if tl.itl_count else 0.0,
                    "max_s": round(tl.itl_max, 6),
                },
            },
        }
        restarts = getattr(req, "restarts", 0)
        if restarts:
            # the request lived through an engine crash-recovery
            # restart (serving/supervisor.py) — on the record AND
            # always flight-recorded below: a stream that survived a
            # crash is precisely the tail the recorder exists for
            record["restarts"] = restarts
        self._observe_phases(phases, tl.xid)
        p99 = self.window_p99_s() if self.slow_ms == 0 else None
        self._lat_window.append(total)
        slow = bool(
            (self.slow_ms > 0 and total * 1000.0 >= self.slow_ms)
            or deadline_missed
            or restarts
            or (p99 is not None and total >= p99)
        )
        if slow:
            record["slow"] = True
            record["deadline_missed"] = bool(deadline_missed)
            # the ONE place step detail survives retirement: a separate
            # copy for the bounded slow ring — the recent ring and the
            # done-payload record stay summary-sized
            detailed = dict(record)
            detailed["steps"] = [
                [n, round(t, 6), round(d, 6)] for n, t, d in tl.steps
            ]
            self._slow_ring.append(detailed)
            self._n_slow += 1
        self._recent.append(record)
        self._n_retired += 1
        tl.record = record
        return record

    def _observe_phases(self, phases: dict, xid: str) -> None:
        if self.metrics is None:
            return
        observe = getattr(self.metrics, "observe_phase", None)
        if observe is None:
            return
        for name, dur in phases.items():
            observe(name, dur, xid)

    # --- cross-thread snapshots ------------------------------------------

    def count_stats(self) -> dict:
        """Scalar counters only — what /v1/health embeds. The full
        timeline copies stay behind request_stats()/slow_stats(), so a
        liveness probe polling health never pays for them."""
        return {
            "retired": self._n_retired,
            "slow": self._n_slow,
            "slow_ms": self.slow_ms,
        }

    def request_stats(self) -> dict:
        """Recent retired-request timelines, newest first (summaries:
        the step detail only rides the slow ring)."""
        return {
            "retired": self._n_retired,
            "slow": self._n_slow,
            "slow_ms": self.slow_ms,
            "requests": [dict(r) for r in reversed(list(self._recent))],
        }

    def get(self, rid: int) -> "dict | None":
        """One recent request's timeline (slow-ring entry preferred:
        it carries the step detail)."""
        for r in reversed(list(self._slow_ring)):
            if r["rid"] == rid:
                return dict(r)
        for r in reversed(list(self._recent)):
            if r["rid"] == rid:
                return dict(r)
        return None

    def slow_stats(self) -> dict:
        """The flight-recorder ring, newest first (full step detail)."""
        p99 = self.window_p99_s()
        return {
            "slow_ms": self.slow_ms,
            "auto_p99_ms": (
                round(p99 * 1000.0, 3) if p99 is not None else None
            ),
            "captured": self._n_slow,
            "requests": [dict(r) for r in reversed(list(self._slow_ring))],
        }
