"""Prefix-affinity replica router: N port replicas behaving like one service.

Port of ``k8s_gpu_device_plugin_tpu/serving/router.py`` on the standard
library: its server and its backend client are ``serving/async_http.py``
(the reference's are aiohttp, which the card's machine does not have),
its metrics the port's own registry (``metrics/exposition.py``, families
``gpu_router_*``). It imports no torch at module import.

Everything below the router is a single-replica stack (one
``InferenceEngine`` per server, serving/server.py); the router is the
first scale-out tier: an asyncio HTTP front end exposing the SAME native
+ OpenAI surfaces, fanning requests out to N replica backends. Three
decisions per request, in order:

1. **Affinity** (``--policy affinity``, the default): the request's
   bucket-aligned token-prefix path (serving/fleet.py
   :func:`~k8s_gpu_device_plugin_torch.serving.fleet.affinity_key` — the
   same ``prompt_buckets`` boundaries the prefix cache promotes at)
   hashes onto a consistent-hash ring; the first ring candidate is the
   key's HOME, where its cached prefix lives. Routing a shared-system-
   prompt tenant anywhere else re-pays the whole prefill — placement is
   semantically load-bearing, not just balancing. ``--policy rr``
   round-robins instead.
2. **Bounded load**: a home drowning in work must spill — a candidate
   already carrying more than ``load_factor`` x the fleet's mean
   in-flight count is skipped for the next ring candidate (so spill
   traffic is deterministic too, not scattered).
3. **Failover**: a connection failure or 429 moves to the next ring
   candidate. 429s honor ``Retry-After`` (delta-seconds AND RFC 9110
   HTTP-dates) — the replica is cooled down for that long. Failures
   BEFORE response headers retry the next candidate; a mid-stream
   replica death on a journaled native SSE stream RESUMES (below);
   everything else surfaces as the stream closing visibly.

**Cross-replica stream resume**: no client-visible stream dies because
a replica did. Each native token-id SSE stream carries a journal (body,
every token/logprob relayed — single-writer, bounded); on a mid-stream
replica death the router resubmits through the native ``resume_out``
seam (emitted tokens folded into the prompt) to the next ring candidate
and splices the continuation into the SAME client response with zero
re-emitted tokens. The port's replicas answer HTTP/1.0 (``http.server``),
so an SSE body ends when its connection closes: a body that ends before
its ``done`` or ``error`` frame is a lost backend, and resumes. Resumes
are budgeted per replica DEATH (``--fleetRestartBudget`` /
``--fleetRestartWindowS``, the supervisor's rolling-budget shape); past
the budget the stream ends with the structured error frame — never a
silent truncation.

**Disaggregated prefill/decode** (``--roles "prefill=r0 decode=r1"``):
a journaled stream of at least ``--disaggMinPrompt`` prompt tokens
prefills on a prefill-capable replica; at its first token the router
exports its KV pages (``POST /v1/kv/export/{id}``), relays any tokens
the export surfaced, and resubmits ``resume_out`` + ``kv_pages`` to a
decode worker, splicing that stream into the same response. Any failed
hop degrades to a plain re-prefill resume (counted as a ``fallback``
transfer, not charged as a death).

**Warm spares** (``--warmSpares N``): the last N ``--replicas`` entries
stay registered and health-polled but OFF the ring; when an active
replica is marked dead, a spare is promoted in its place.

**Rolling restart** (``POST /fleet/rolling-restart``): drain ->
restart-wait -> undrain sequenced across the fleet, one replica at a
time — zero dropped and zero from-scratch-retried streams. A new
process is told by the replica's ``/v1/health`` ``uptime_s`` resetting.

**Observability** (obs/fleet_obs.py): ``GET /fleet/events`` is the
journal of every fleet operation (deterministic under the seeded fault
plane); ``GET /fleet/debug/requests`` serves per-stream router timelines
whose route/relay/resume-gap segments sum EXACTLY to the client-observed
wall time, retained for resumed/failed-over/SLO-breaching streams by a
flight recorder; ``GET /debug/traces`` is the router's own trace ring.
Spans propagate via W3C ``traceparent``: the router's span becomes the
remote parent of the replica's ``serving_http`` span, and ``GET
/fleet/debug/traces/{id}`` stitches the router's ring and every
replica's fragments of one trace into one Perfetto document (one process
row per replica). ``GET /fleet/metrics`` federates every replica's
``/metrics`` under a ``replica`` label with ``gpu_fleet_*`` aggregates,
classic or OpenMetrics as the scraper asks. ``--plugins``
(device-plugin federation) is refused naming ROADMAP A.14.

Liveness comes from polling each replica's ``/v1/health``:
``dead_after`` consecutive failures (poll or proxy) mark a replica dead
and routing skips it; any success revives it. Fleet operations:
``POST /fleet/drain/{replica}`` (stop new admissions, wait until its
in-flight streams retire; 504 with ``drained: false`` past
``drain_timeout_s``), ``POST /fleet/undrain/{replica}``, ``GET
/fleet/health`` (the aggregate). When NO replica can admit, submits are
refused with a structured 503 (``draining`` or ``no_replica``); when
every candidate answered 429, the LAST 429 is forwarded.

The proxy is byte-transparent: request bodies are forwarded exactly as
received and response bodies/SSE frames relayed unmodified, so streams
through the router are bit-identical to direct submission.

Event-loop discipline: single-threaded asyncio end to end — backend I/O
is ``async_http``'s client, waits are ``asyncio.sleep``.

Run: ``python -m k8s_gpu_device_plugin_torch.serving.router --replicas
r0=http://127.0.0.1:8731,r1=http://127.0.0.1:8732 --port 8100``.
"""

from __future__ import annotations

import asyncio
import json
import math
import time

from k8s_gpu_device_plugin_torch.metrics.exposition import (
    CONTENT_TYPE_CLASSIC,
    CONTENT_TYPE_OPENMETRICS,
    OPENMETRICS_ACCEPT,
    Counter,
    Gauge,
    Registry,
)
from k8s_gpu_device_plugin_torch.obs.fleet_obs import (
    PLUGINS_ITEM,
    FleetEventJournal,
    RouterFlightRecorder,
    federate_metrics,
    spans_from_chrome,
    stitched_trace_payload,
)
from k8s_gpu_device_plugin_torch.obs.http import (
    is_observation_path,
    parse_trace_query,
    route_label,
    trace_detail_payload,
    traces_payload,
)
from k8s_gpu_device_plugin_torch.obs.trace import (
    TRACEPARENT_HEADER,
    current_context,
    current_trace_ids,
    format_traceparent,
    get_tracer,
    parse_traceparent,
)
from k8s_gpu_device_plugin_torch.serving import async_http
from k8s_gpu_device_plugin_torch.serving.async_http import (
    ClientGone as _ClientGone,
    Response,
    StreamResponse,
    json_response,
)
from k8s_gpu_device_plugin_torch.serving.faults import FaultError
from k8s_gpu_device_plugin_torch.serving.fleet import (
    FleetRegistry,
    FleetRestartBudget,
    HashRing,
    Replica,
    affinity_key,
    parse_retry_after,
    poll_phase,
)
from k8s_gpu_device_plugin_torch.utils.log import get_logger

log = get_logger()

#: proxied POST surfaces (both APIs; the router adds nothing of its own
#: to them — byte-transparent by contract)
PROXY_POSTS = (
    "/v1/generate", "/v1/completions", "/v1/chat/completions",
    "/v1/embeddings",
)

#: the base model's OpenAI ``model`` id (serving/openai_api.py's
#: MODEL_ID; kept here so the router imports no torch)
MODEL_ID = "tpu-serving"


class RouterMetrics:
    """Prometheus mirror of the router's counters on ``registry`` (the
    plain ``router_stats()`` snapshot always exists). Family names are
    fixed; call :meth:`close` before building a second instance on the
    same registry."""

    def __init__(self, registry: Registry, prefix: str = "gpu_router"):
        self._registry = registry
        self.requests = Counter(
            f"{prefix}_requests_total",
            "Requests relayed, by replica and outcome",
            ["replica", "outcome"],
            registry=registry,
        )
        self.affinity_hits = Counter(
            f"{prefix}_affinity_hits_total",
            "Requests dispatched to their ring-home replica",
            registry=registry,
        )
        self.failovers = Counter(
            f"{prefix}_failovers_total",
            "Dispatch attempts beyond the first candidate "
            "(connection failure or 429 moved the request on)",
            registry=registry,
        )
        self.promotions = Counter(
            f"{prefix}_promotions_total",
            "Warm spares promoted into the ring after an active "
            "replica died",
            registry=registry,
        )
        self.stream_resumes = Counter(
            f"{prefix}_stream_resumes_total",
            "Mid-stream replica deaths resumed onto another replica "
            "(the client-visible stream continued, zero re-emitted "
            "tokens)",
            registry=registry,
        )
        self.kv_transfers = Counter(
            f"{prefix}_kv_transfers_total",
            "Disaggregated prefill->decode KV-page transfers, by "
            "outcome (ok; fallback = degraded to re-prefill; "
            "completed_on_prefill = the stream finished before any "
            "transfer was needed)",
            ["outcome"],
            registry=registry,
        )
        self.inflight = Gauge(
            f"{prefix}_inflight",
            "Requests currently relayed to each replica",
            ["replica"],
            registry=registry,
        )
        self.replica_up = Gauge(
            f"{prefix}_replica_up",
            "1 = replica routable (alive, not draining, not cooling down)",
            ["replica"],
            registry=registry,
        )

    def close(self) -> None:
        for c in (self.requests, self.affinity_hits, self.failovers,
                  self.promotions, self.stream_resumes, self.kv_transfers,
                  self.inflight, self.replica_up):
            try:
                self._registry.unregister(c)
            except KeyError:
                pass  # already unregistered


class _Unreachable(Exception):
    """Connection-level failure before response headers: safe to retry
    the next ring candidate (no bytes reached the client)."""


class _Overloaded(Exception):
    """Backend answered 429: cool the replica down for Retry-After and
    try the next candidate; forwarded verbatim if every candidate 429s."""

    def __init__(self, body: bytes, retry_after: int, content_type: str):
        super().__init__("backend overloaded")
        self.body = body
        self.retry_after = retry_after
        self.content_type = content_type


class _StreamJournal:
    """One in-flight resumable stream's recovery record: the original
    request body plus every (token, logprob) relayed so far. Written by
    exactly ONE task — the relay pumping that stream — and bounded:
    tokens cannot outgrow the request's ``max_new``, and the router caps
    how many streams are journaled at once (``journal_limit`` — a stream
    past the cap serves normally, it just isn't resumable, counted in
    ``router_stats``)."""

    __slots__ = ("body", "key", "tokens", "logps", "closed")

    def __init__(self, body: dict, key: "bytes | None"):
        self.body = body                       # parsed original request
        self.key = key                         # its ring affinity key
        # pre-seed with a client-supplied resume: those tokens were
        # already delivered by an EARLIER incarnation, so a death here
        # must carry them forward too
        self.tokens: list[int] = [
            int(t) for t in (body.get("resume_out") or ())
        ]
        self.logps: list[float] = [
            float(x) for x in (body.get("resume_logprobs") or ())
        ]
        if len(self.logps) < len(self.tokens):
            self.logps += [0.0] * (len(self.tokens) - len(self.logps))
        self.closed = False                    # done/error frame relayed

    def observe(self, evt: dict) -> None:
        if "token" in evt:
            self.tokens.append(int(evt["token"]))
            self.logps.append(float(evt.get("logprob", 0.0)))
        elif "done" in evt or "error" in evt:
            self.closed = True

    def resume_body(self) -> bytes:
        body = dict(self.body)
        if self.tokens:
            body["resume_out"] = list(self.tokens)
            body["resume_logprobs"] = list(self.logps)
        else:
            # died before any token was relayed: a plain from-scratch
            # resubmit IS the resume (there is nothing to fold)
            body.pop("resume_out", None)
            body.pop("resume_logprobs", None)
        return json.dumps(body).encode()


class _BackendLost(Exception):
    """The backend died mid-SSE-relay (after headers, before the done
    frame): the resume path's trigger. Carries nothing — the journal
    has everything."""


def _sse_response() -> StreamResponse:
    return StreamResponse(headers={"Content-Type": "text/event-stream",
                                   "Cache-Control": "no-cache"})


def _plain(body: bytes, status: int, ctype: str) -> Response:
    return Response(body, status=status,
                    content_type=ctype.split(";")[0] or "application/json")


class ReplicaRouter:
    """``async_http`` app over a FleetRegistry (port 0 = ephemeral)."""

    def __init__(
        self,
        fleet: FleetRegistry,
        host: str = "0.0.0.0",
        port: int = 8100,
        policy: str = "affinity",
        prompt_buckets: "tuple[int, ...] | None" = None,  # None = the
        # batcher's DEFAULT_PROMPT_BUCKETS ladder — affinity keys are
        # only load-bearing when they cut at the boundaries the
        # replicas' prefix caches promote at, so a fleet whose replicas
        # run custom buckets (or a small --maxLen trimming the ladder)
        # must pass the same ladder here (--promptBuckets on the CLI)
        load_factor: float = 1.25,
        health_interval_s: float = 1.0,
        drain_timeout_s: float = 120.0,
        connect_timeout_s: float = 2.0,
        header_timeout_s: float = 300.0,  # finite: a wedged replica
        # must fail over, not hang the client forever (0 = unbounded)
        resume_timeout_s: float = 30.0,  # how long a mid-stream resume
        # keeps retrying candidates (429s honored, promotions awaited)
        # before the stream ends with the structured error frame
        registry: "Registry | None" = None,  # None = no /metrics
        metrics: "RouterMetrics | None" = None,
        faults=None,            # serving.faults.FaultPlane (None = disarmed)
        warm_spares: int = 0,   # last N --replicas entries held OFF the
        # ring as standbys, promoted when an active replica dies
        fleet_restart_budget: int = 3,   # replica-death stream resumes
        fleet_restart_window_s: float = 300.0,  # per rolling window
        journal_limit: int = 1024,  # concurrent streams journaled for
        # resume; streams past the cap serve normally, un-resumably
        journal_events: int = 1024,  # fleet event journal ring size
        # (obs/fleet_obs.py; GET /fleet/events)
        timelines: bool = True,  # router-side request timelines + the
        # flight recorder (GET /fleet/debug/requests); False leaves the
        # proxy hot path with is-not-None guards only
        slow_stream_ms: float = 0.0,  # SLO-breach retention threshold
        # for the router flight recorder (resumed/failed-over/error
        # streams are always retained; 0 = only those)
        roles: "str | None" = None,  # disaggregated prefill/decode:
        # a --roles spec ("prefill=idA,idB decode=idC"; unlisted
        # replicas stay 'any'). None/empty leaves routing byte-
        # identical to an unroled fleet
        disagg_min_prompt: int = 64,  # prompts at least this many
        # tokens (journaled native SSE streams only) take the
        # prefill-worker -> KV-transfer -> decode-worker path; shorter
        # ones go straight to a decode-capable replica
        plugins: "list[tuple[str, str]] | None" = None,  # device-plugin
        # control planes to federate: refused until the device plugin
        # is ported (ROADMAP A.14)
        adapter_names: "tuple[str, ...] | None" = None,  # LoRA adapters
        # the replicas serve: a request selecting a LISTED adapter folds
        # its name into the affinity key, so one adapter's traffic
        # concentrates on the replica(s) already holding its stacks
        # resident. Unlisted/base requests keep the pre-adapter key.
    ):
        if policy not in ("affinity", "rr"):
            raise ValueError(
                f"unknown router policy {policy!r} "
                "(expected 'affinity' or 'rr')"
            )
        if load_factor <= 1.0:
            raise ValueError(
                f"load_factor must be > 1.0, got {load_factor} "
                "(1.0 would refuse the mean load itself)"
            )
        if plugins:
            raise ValueError(
                "device-plugin federation (--plugins) waits for the port "
                f"of the device plugin ({PLUGINS_ITEM})"
            )
        self.fleet = fleet
        if roles:
            fleet.assign_roles(roles)
        # computed ONCE: every disaggregation branch below gates on
        # this, so an unroled fleet runs the exact pre-roles code paths
        self._roles_on = fleet.roles_configured()
        self.disagg_min_prompt = int(disagg_min_prompt)
        if warm_spares:
            fleet.mark_spares(warm_spares)
        # the ring is the ACTIVE membership only: spares join (and dead
        # actives leave) at promotion time, remapping affinity keys the
        # consistent-hashing way (~1/N of the keyspace moves)
        self.ring = HashRing([r.rid for r in fleet.active()])
        self.host = host
        self.port = port
        self.bound_port: int | None = None
        self.policy = policy
        if prompt_buckets is None:
            # imported here: the batching module brings torch with it
            from k8s_gpu_device_plugin_torch.models.batching import (
                DEFAULT_PROMPT_BUCKETS,
            )

            prompt_buckets = DEFAULT_PROMPT_BUCKETS
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.adapter_names = frozenset(adapter_names or ())
        self._adapter_requests: dict[str, int] = {}  # listed-name tally
        self.load_factor = float(load_factor)
        self.health_interval_s = float(health_interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        # bound the HEADER phase of a dispatch (a wedged replica whose
        # socket accepts but never answers must fail over like a
        # connection failure, not hang the client forever). The default
        # sits ABOVE the worst legitimate case — a non-streamed
        # generate's headers arrive only when generation completes — so
        # a premature timeout cannot cascade failovers across a healthy
        # fleet. Operators who stream can set this tight; 0 = unbounded.
        self.header_timeout_s = float(header_timeout_s)
        self.resume_timeout_s = float(resume_timeout_s)
        # seeded fault injection (serving/faults.py): the two
        # router-side seams — pre-dispatch connect and mid-SSE-relay
        self._flt_connect = (
            faults.point("router.connect") if faults is not None else None
        )
        self._flt_midstream = (
            faults.point("router.midstream") if faults is not None else None
        )
        self.registry = registry
        self.metrics = metrics
        self.tracer = get_tracer()
        self._rr_next = 0
        # cross-replica stream resume: budgeted like the supervisor's
        # restarts, one charge per replica DEATH (not per stream)
        self._fleet_budget = FleetRestartBudget(
            fleet_restart_budget, fleet_restart_window_s
        )
        self.journal_limit = int(journal_limit)
        self._journaled = 0       # streams currently carrying a journal
        # the event journal (always on — it writes only on failure/
        # control-plane paths) and the per-stream timeline flight
        # recorder (optional)
        self.journal = FleetEventJournal(maxlen=journal_events)
        self._recorder: "RouterFlightRecorder | None" = (
            RouterFlightRecorder(slow_ms=slow_stream_ms)
            if timelines else None
        )
        # plain counters (always on; RouterMetrics mirrors them):
        # /fleet/health reads these
        self._requests = 0
        self._affinity_hits = 0
        self._failovers = 0
        self._promotions = 0
        self._resumes = 0          # mid-stream deaths spliced over
        self._resume_failures = 0  # ended with the structured error frame
        # disaggregated prefill/decode bookkeeping: transfers by
        # outcome, pages shipped, and a bounded wall-time sample ring
        self._kv_transfers: dict[str, int] = {}
        self._kv_transfer_pages = 0
        self._kv_transfer_ms: list[float] = []
        self._unjournaled = 0      # streams served past journal_limit
        self._refused: dict[str, int] = {}
        self._outcomes: dict[str, int] = {}
        self._poll_task: asyncio.Task | None = None
        self.app = async_http.HttpServer(middleware=self._trace_middleware)
        for path in PROXY_POSTS:
            self.app.add_post(path, self._proxy_post)
        self.app.add_get("/v1/models", self._proxy_get)
        self.app.add_get("/v1/health", self._health)
        self.app.add_get("/fleet/health", self._fleet_health)
        self.app.add_post("/fleet/drain/{replica}", self._drain)
        self.app.add_post("/fleet/undrain/{replica}", self._undrain)
        self.app.add_post("/fleet/rolling-restart", self._rolling_restart)
        # the router's OWN trace ring (same ?limit=/?since= surface as
        # the replicas'), the event journal and the stream timelines
        self.app.add_get("/debug/traces", self._debug_traces)
        self.app.add_get("/debug/traces/{trace_id}", self._debug_trace_one)
        self.app.add_get("/fleet/debug/traces/{trace_id}",
                         self._fleet_trace_one)
        self.app.add_get("/fleet/metrics", self._fleet_metrics)
        self.app.add_get("/fleet/events", self._fleet_events)
        self.app.add_get("/fleet/debug/requests", self._fleet_requests)
        self.app.add_get("/fleet/debug/requests/{rid}",
                         self._fleet_request_one)
        if registry is not None:
            self.app.add_get("/metrics", self._metrics)

    # --- lifecycle --------------------------------------------------------

    async def run(self, stop: asyncio.Event) -> None:
        """Serve until ``stop`` is set (the InferenceServer idiom)."""
        try:
            # everything is inside the try: a bind failure must not leak
            # a live poller into the embedding process
            self._poll_task = asyncio.ensure_future(self._poll_loop())
            self.bound_port = await self.app.start(self.host, self.port)
            log.info(
                "replica router listening",
                extra={"fields": {
                    "addr": f"{self.host}:{self.bound_port}",
                    "policy": self.policy,
                    "replicas": self.fleet.ids(),
                }},
            )
            await stop.wait()
        finally:
            if self._poll_task is not None:
                self._poll_task.cancel()
                try:
                    await self._poll_task
                except asyncio.CancelledError:
                    pass
                self._poll_task = None
            await self.app.close()

    # --- health polling ---------------------------------------------------

    async def _probe_health(self, rep: Replica) -> dict | None:
        """One /v1/health contact, feeding the liveness ledger either
        way: a 200 payload revives the replica, anything else (engine
        dead behind a live socket, unreachable, garbage JSON) counts a
        failure. The poll loop AND the drain wait share this."""
        try:
            status, _, body = await async_http.fetch(
                "GET", f"{rep.url}/v1/health",
                timeout_s=self.connect_timeout_s,
            )
            if status != 200:
                self.fleet.note_failure(rep)
                return None
            # ValueError covers json.JSONDecodeError (a truncated body
            # must count as a failed probe, not kill the poller)
            health = json.loads(body)
        except (OSError, asyncio.TimeoutError, ValueError):
            self.fleet.note_failure(rep)
            return None
        self.fleet.note_success(rep, health)
        return health

    async def _poll_one(self, rep: Replica) -> None:
        """One replica's probe, hardened: ANY unexpected exception (a
        pathological payload — anything _probe_health's expected-failure
        net doesn't catch) counts a liveness failure for THIS replica
        and never reaches the poll loop — one bad replica must not blind
        routing to the rest."""
        try:
            await self._probe_health(rep)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 - a dead poller blinds routing
            log.exception(
                "health probe failed unexpectedly",
                extra={"fields": {"replica": rep.rid}},
            )
            self.fleet.note_failure(rep)

    async def _poll_loop(self) -> None:
        """One staggered probe loop per replica: each replica's probes
        fire at a deterministic phase offset inside the interval
        (serving/fleet.py ``poll_phase``), so an N-replica fleet does
        not synchronize its health probes into a thundering herd. Spares
        are polled too — a promotion must hand traffic to a replica
        whose liveness is current, not assumed."""

        async def one(rep: Replica) -> None:
            await asyncio.sleep(poll_phase(rep.rid, self.health_interval_s))
            while True:
                try:
                    await self._poll_one(rep)
                    self._maybe_promote()
                    if self.metrics is not None:
                        self.metrics.replica_up.labels(rep.rid).set(
                            1 if rep.routable(time.monotonic()) else 0
                        )
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 - a dead poller blinds
                    log.exception("router health poll pass failed")
                await asyncio.sleep(self.health_interval_s)

        tasks = [
            asyncio.ensure_future(one(rep)) for rep in self.fleet.all()
        ]
        try:
            await asyncio.gather(*tasks)
        finally:
            for t in tasks:
                t.cancel()

    # --- warm spares ------------------------------------------------------

    def _maybe_promote(self) -> None:
        """Promote warm spares over dead active replicas (called from
        the poll loop and from proxy-observed failures — wherever a
        death becomes visible). Each promotion swaps ring membership
        and rebuilds the ring once, remapping affinity keys; surfaced
        on /fleet/health (``promotions``) and
        ``gpu_router_promotions_total``."""
        promoted = False
        for rep in self.fleet.active():
            if rep.alive:
                continue
            spare = self.fleet.promote_spare(rep)
            if spare is None:
                break  # no idle live spare; later deaths can't do better
            promoted = True
            self._promotions += 1
            if self.metrics is not None:
                self.metrics.promotions.inc()
            self.journal.emit("promote", promoted=spare.rid,
                              replaced=rep.rid)
            log.warning(
                "promoted warm spare into the ring",
                extra={"fields": {"replica": spare.rid,
                                  "promoted": spare.rid,
                                  "replaced": rep.rid,
                                  "promotions": self._promotions}},
            )
        if promoted:
            self.ring = HashRing([r.rid for r in self.fleet.active()])

    # --- tracing ----------------------------------------------------------

    async def _trace_middleware(self, request, handler):
        if not self.tracer.enabled:
            return await handler(request)
        remote = parse_traceparent(request.headers.get(TRACEPARENT_HEADER))
        if remote is None and is_observation_path(request.path):
            # telemetry reads (LB health probes, scrapes) may join a
            # trace but never start one — root spans per observation
            # would churn the router's own ring
            return await handler(request)
        with self.tracer.span(
            f"{request.method} {route_label(request)}",
            component="router_http",
            parent=remote, method=request.method, path=request.path,
        ) as span:
            response = await handler(request)
            span.set(status_code=response.status)
            if not response.prepared:  # SSE relays already sent headers
                response.headers[TRACEPARENT_HEADER] = format_traceparent(span)
            return response

    def _backend_headers(self, request) -> dict:
        headers = {
            "Content-Type": request.headers.get(
                "Content-Type", "application/json"
            ),
        }
        if self.tracer.enabled:
            ctx = current_context()
            if ctx is not None:
                # the router span becomes the replica span's remote
                # parent: one trace covers edge -> router -> engine
                headers[TRACEPARENT_HEADER] = format_traceparent(ctx)
        return headers

    # --- routing ----------------------------------------------------------

    def _affinity_source(self, path: str, body) -> object | None:
        """The prefix-bearing field of each surface. Chat messages key
        on the serialized message list — the system prompt + history
        prefix is its head, which is exactly what the replica's prefix
        cache will match after templating."""
        if not isinstance(body, dict):
            return None
        if path == "/v1/generate":
            return body.get("prompt") or body.get("text")
        if path == "/v1/completions":
            return body.get("prompt")
        if path == "/v1/chat/completions":
            return body.get("messages")
        return None  # embeddings: no KV reuse — balance only

    @staticmethod
    def _adapter_source(path: str, body) -> "str | None":
        """The adapter-selecting field of each surface: the native
        ``"adapter"`` name, or the OpenAI ``"model"`` when it names
        something other than the base model. None = base-model request
        (or a surface with no adapter notion — embeddings)."""
        if not isinstance(body, dict):
            return None
        if path == "/v1/generate":
            name = body.get("adapter")
            return name if isinstance(name, str) and name else None
        if path in ("/v1/completions", "/v1/chat/completions"):
            name = body.get("model")
            if isinstance(name, str) and name and name != MODEL_ID:
                return name
        return None

    def _fold_adapter(self, path: str, body, key: "bytes | None"):
        """Prefold a LISTED adapter's name onto the affinity key: the
        adapter's stacks are device state exactly like a promoted prefix,
        so its traffic should concentrate where they already live. The
        fold prefixes rather than replaces — requests on one adapter
        still spread by prompt prefix once they share a home
        neighborhood. Unlisted or base-model requests return ``key``
        unchanged."""
        name = self._adapter_source(path, body)
        if name is None or name not in self.adapter_names:
            return key
        self._adapter_requests[name] = (
            self._adapter_requests.get(name, 0) + 1
        )
        return b"a:" + name.encode() + b"\x00" + (key or b"")

    @staticmethod
    def _resumable_body(path: str, body) -> bool:
        """Which streams can carry a recovery journal: the native SSE
        surface with a token-id prompt and n=1 — exactly what the
        resume seam (``resume_out``) is defined over. Text prompts need
        the replica's tokenizer (the router has none), n>1 has no
        single stream to splice, and the OpenAI SSE framing carries no
        raw token ids to journal; those streams serve exactly as
        before (a mid-stream death stays a visible truncation the
        client retries)."""
        if path != "/v1/generate" or not isinstance(body, dict):
            return False
        if not body.get("stream"):
            return False
        prompt = body.get("prompt")
        if (not isinstance(prompt, list) or not prompt or not all(
            isinstance(t, int) and not isinstance(t, bool) for t in prompt
        )):
            return False
        try:
            if int(body.get("n", 1) or 1) != 1:
                return False
        except (TypeError, ValueError):
            return False
        # a client-supplied resume pre-seeds the journal: malformed
        # fields must not be journaled (the int()/float() casts would
        # 500 here) — forwarded unjournaled, the replica answers its
        # clean 4xx
        rout = body.get("resume_out")
        if rout is not None and (
            not isinstance(rout, list) or not all(
                isinstance(t, int) and not isinstance(t, bool)
                for t in rout
            )
        ):
            return False
        rlps = body.get("resume_logprobs")
        if rlps is not None and (
            not isinstance(rlps, list) or not all(
                isinstance(x, (int, float)) and not isinstance(x, bool)
                for x in rlps
            )
        ):
            return False
        return True

    def _pick(
        self, key: bytes | None, role: "str | None" = None
    ) -> tuple[list[Replica], "Replica | None"]:
        """-> (dispatch order, the key's ring HOME or None). Affinity
        walks the ring from the key's point and applies the
        bounded-load skip; rr (or a keyless request) rotates over the
        live set. An empty list means nobody can admit right now.

        ``role`` narrows the candidates to replicas that can serve that
        side of a disaggregated fleet (exact role or ``"any"``); when
        NO live replica covers the role, the filter falls away — a
        specialized fleet degraded to one surviving generalist must
        keep serving, not refuse on principle."""
        now = time.monotonic()
        live = [r for r in self.fleet.all() if r.routable(now)]
        if not live:
            # cooldown is ADVICE, not refusal: with every candidate
            # cooling down from a 429, the backend's own 429 (fresh
            # Retry-After included) is the right answer — not a made-up
            # 503. Draining/dead/spare replicas stay excluded.
            live = [
                r for r in self.fleet.all()
                if r.alive and not r.draining and not r.spare
            ]
        if role is not None and self._roles_on:
            roled = [r for r in live if r.role in (role, "any")]
            if roled:
                live = roled
        if not live:
            return [], None
        usable = set(id(r) for r in live)
        if self.policy == "rr" or key is None:
            self._rr_next += 1
            i = self._rr_next % len(live)
            return live[i:] + live[:i], None
        ring_order = [
            self.fleet.get(rid) for rid in self.ring.candidates(key)
        ]
        home = ring_order[0] if ring_order else None
        order = [
            r for r in ring_order if r is not None and id(r) in usable
        ]
        if not order:
            return [], None
        # bounded load: a candidate already past load_factor x the mean
        # in-flight spills to the NEXT ring candidate (deterministic
        # spill target), never to a random replica
        cap = max(2.0, math.ceil(
            self.load_factor * (sum(r.inflight for r in live) + 1)
            / len(live)
        ))
        target = next((r for r in order if r.inflight < cap), None)
        if target is None:
            target = min(order, key=lambda r: r.inflight)
        rest = [r for r in order if r is not target]
        return [target] + rest, home

    # --- refusals (per-surface shapes) ------------------------------------

    def _refuse(self, path: str, code: str, message: str,
                status: int = 503) -> Response:
        self._refused[code] = self._refused.get(code, 0) + 1
        if self.metrics is not None:
            self.metrics.requests.labels("none", code).inc()
        if path == "/v1/generate":
            # the native structured-error shape (the 429 body's sibling)
            resp = json_response(
                {"error": message, "code": code}, status=status
            )
        else:
            # OpenAI envelope; 5xx reads as retryable server_error,
            # which is what a drain IS from the client's side
            resp = json_response(
                {"error": {"message": message, "type": "server_error",
                           "code": code}},
                status=status,
            )
        # the timeline outcome must tell a ROUTER refusal (this 503)
        # apart from a relayed backend 5xx
        resp.router_refusal = code
        return resp

    # --- the proxy --------------------------------------------------------

    async def _proxy_post(self, request):
        # the stream timeline starts at request receipt: the segments
        # below sum exactly to the wall time THIS seam observed
        # (obs/fleet_obs.RouterTimeline)
        tl = None
        if self._recorder is not None:
            ids = current_trace_ids()
            tl = self._recorder.start(
                request.path, ids[0] if ids is not None else ""
            )
        raw = request.body
        try:
            body = json.loads(raw) if raw else None
        except ValueError:
            body = None  # the backend's 400 is the authoritative answer
        key = affinity_key(
            self._affinity_source(request.path, body), self.prompt_buckets
        )
        key = self._fold_adapter(request.path, body, key)
        # disaggregated prefill/decode (--roles): journaled long-prompt
        # streams take the prefill-worker leg (relay until the first
        # token, export the KV pages, resubmit to a decode worker);
        # everything else routes to decode-capable replicas so prefill
        # workers stay clear for prefill bursts. All of it is inert on
        # an unroled fleet (role=None -> the pre-roles code paths).
        wants_disagg = (
            self._roles_on
            and self._resumable_body(request.path, body)
            and body.get("kv_pages") is None
            and not body.get("resume_out")
            and len(body.get("prompt") or ()) >= self.disagg_min_prompt
        )
        role = None
        if self._roles_on and request.path != "/v1/embeddings":
            role = "prefill" if wants_disagg else "decode"
        order, home = self._pick(key, role=role)
        if not order:
            if self.fleet.any_draining():
                resp = self._refuse(
                    request.path, "draining",
                    "all replicas are draining; retry after the rolling "
                    "update completes",
                )
            else:
                resp = self._refuse(
                    request.path, "no_replica",
                    "no live replica available",
                )
            if tl is not None:
                self._recorder.on_done(tl.finalize("refused", resp.status))
            return resp
        self._requests += 1
        headers = self._backend_headers(request)
        # journal eligibility: native token-id SSE streams (n=1) carry
        # a recovery journal so a mid-stream replica death resumes on
        # another ring candidate instead of truncating the client
        journal: "_StreamJournal | None" = None
        if self._resumable_body(request.path, body):
            if self._journaled < self.journal_limit:
                journal = _StreamJournal(body, key)
                self._journaled += 1
            else:
                self._unjournaled += 1
        disagg = wants_disagg and journal is not None
        if wants_disagg and journal is None:
            # past the journal cap there is no token record to drive a
            # transfer: serve colocated on a decode-capable replica
            # instead of stranding a decoding stream on a prefill one
            order, home = self._pick(key, role="decode")
        resp = None
        try:
            resp = await self._dispatch(
                request, raw, headers, order, home, journal, tl,
                relay=self._relay_disagg if disagg else None,
            )
            return resp
        finally:
            if journal is not None:
                self._journaled -= 1
            if tl is not None:
                if journal is not None:
                    tl.tokens = len(journal.tokens)
                if resp is None:
                    # the handler is unwinding (cancellation): the wall
                    # time still closes exactly
                    rec = tl.finalize("cancelled")
                else:
                    rec = tl.finalize(
                        self._tl_outcome(tl, resp), resp.status
                    )
                self._recorder.on_done(rec)

    @staticmethod
    def _tl_outcome(tl, resp) -> str:
        """Collapse a finished relay into the timeline's outcome label
        (the flight recorder's retention key). Agrees with the
        ``_outcome`` counter taxonomy: a relayed backend 5xx is
        ``backend_error``; ``refused`` is reserved for the router's own
        503s (``_refuse`` tags those)."""
        if tl.error_code:
            return tl.error_code    # fleet_budget_exhausted/resume_failed
        if getattr(resp, "router_refusal", None) is not None:
            return "refused"
        status = resp.status
        if status == 429:
            return "overloaded"
        if status >= 500:
            return "backend_error"
        if status >= 400:
            return "client_error"
        return "resumed" if tl.resumes else "ok"

    async def _dispatch(self, request, raw: bytes,
                        headers: dict, order: "list[Replica]",
                        home: "Replica | None",
                        journal: "_StreamJournal | None",
                        tl=None,
                        relay=None,  # per-attempt relay (default
                        # self._relay; the disagg path substitutes
                        # _relay_disagg and rides the same failover
                        # loop, cooldown handling, and postlude)
                        ):
        relay_fn = relay if relay is not None else self._relay
        last_429: _Overloaded | None = None
        for attempt, rep in enumerate(order):
            if attempt > 0:
                self._failovers += 1
                if tl is not None:
                    tl.failovers += 1
                if self.metrics is not None:
                    self.metrics.failovers.inc()
                self.journal.emit(
                    "failover", path=request.path,
                    prev=order[attempt - 1].rid, replica=rep.rid,
                    attempt=attempt,
                )
            rep.inflight += 1
            if self.metrics is not None:
                self.metrics.inflight.labels(rep.rid).set(rep.inflight)
            if self.tracer.enabled:
                log.debug(
                    "request submitted to replica",
                    extra={"fields": {
                        "replica": rep.rid,
                        "path": request.path,
                        "affinity_hit": rep is home,
                        "attempt": attempt,
                    }},
                )
            try:
                resp = await relay_fn(rep, request, raw, headers,
                                      journal=journal, tl=tl)
            except _Unreachable:
                self.fleet.note_failure(rep)
                self._maybe_promote()
                self._count(rep, "unreachable")
                continue
            except _Overloaded as e:
                rep.cooldown_until = time.monotonic() + e.retry_after
                self._count(rep, "overloaded")
                self.journal.emit("cooldown_429", replica=rep.rid,
                                  retry_after_s=e.retry_after)
                last_429 = e
                continue
            finally:
                rep.inflight -= 1
                if self.metrics is not None:
                    self.metrics.inflight.labels(rep.rid).set(rep.inflight)
            final = getattr(resp, "router_final_rep", rep)
            if final is rep:
                if resp.status < 500:
                    # only app-level answers prove the engine alive; a
                    # 5xx (dead engine behind a live socket) must keep
                    # counting toward dead_after
                    self.fleet.note_success(rep)
                else:
                    self.fleet.note_failure(rep)
                self._count(rep, self._outcome(resp.status))
            # else: the stream died under rep mid-relay and the resume
            # path already fed the liveness ledger and outcome counters
            # for both the dead replica and whoever finished the stream
            if rep is home:
                # counted on the SERVING dispatch, not at plan time: a
                # home that failed over is a miss for cache locality
                self._affinity_hits += 1
                if tl is not None:
                    tl.affinity_hit = True
                if self.metrics is not None:
                    self.metrics.affinity_hits.inc()
            if self.tracer.enabled:
                # the middleware span gains the routing decision: which
                # replica served, whether the ring home took it, whether
                # the resume path spliced it
                span = current_context()
                if span is not None and hasattr(span, "set"):
                    span.set(
                        replica=(final.rid if final is not None
                                 else rep.rid),
                        affinity_hit=rep is home,
                        resumed=(final is not None and final is not rep),
                    )
            return resp
        if last_429 is not None:
            # every candidate said "not now": deliver the backend's own
            # overload message + Retry-After, don't invent a new one
            return Response(
                last_429.body, status=429,
                content_type=last_429.content_type,
                headers={"Retry-After": str(last_429.retry_after)},
            )
        return self._refuse(
            request.path, "no_replica",
            "every replica is unreachable",
        )

    @staticmethod
    def _outcome(status: int) -> str:
        if status < 400:
            return "ok"
        return "client_error" if status < 500 else "backend_error"

    def _count(self, rep: Replica, outcome: str) -> None:
        rep.relayed += 1
        self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1
        if self.metrics is not None:
            self.metrics.requests.labels(rep.rid, outcome).inc()

    async def _open_backend(self, url: str, raw: bytes, headers: dict):
        """POST to a backend, bounding the HEADER phase: the request
        resolves when response headers arrive, so the timeout covers
        exactly the wedge window — the body/SSE relay stays unbounded
        (legitimate long generations). Raises _Unreachable for the
        failover loop."""
        try:
            return await async_http.request(
                "POST", url, raw, headers,
                header_timeout_s=self.header_timeout_s,
                connect_timeout_s=self.connect_timeout_s,
            )
        except (OSError, asyncio.TimeoutError) as e:
            raise _Unreachable(str(e) or type(e).__name__) from None

    async def _pump_sse(self, resp, out: StreamResponse,
                        journal: "_StreamJournal | None") -> None:
        """Relay one backend SSE body into the client stream.

        Without a journal: the byte-transparent chunk relay
        (non-resumable streams — OpenAI SSE, text prompts, n>1); a
        backend death ends the stream visibly truncated.

        With a journal: frames are forwarded at event granularity (the
        bytes of each complete frame pass unmodified, so the relay
        stays byte-transparent for streams that finish) and every
        token/logprob is journaled as it passes; a backend death —
        or the armed ``router.midstream`` fault — raises _BackendLost,
        the resume path's trigger. Buffering to frame boundaries is
        what makes the splice clean: a death mid-frame discards the
        partial frame instead of gluing half a JSON line to the
        continuation."""
        if journal is None:
            async for chunk in resp.iter_any():
                await out.write(chunk)
                if self._flt_midstream is not None:
                    try:
                        self._flt_midstream.fire()
                    except FaultError:
                        # injected mid-relay death on a non-resumable
                        # stream: close the backend HARD and end the
                        # client stream without a done event — a
                        # VISIBLE truncation, never retried
                        resp.close()
                        return
            return
        buf = b""
        try:
            async for chunk in resp.iter_any():
                buf += chunk
                while b"\n\n" in buf:
                    frame, buf = buf.split(b"\n\n", 1)
                    await out.write(frame + b"\n\n")
                    self._observe_frame(journal, frame)
                    # the fault advances per FRAME, not per network
                    # chunk: TCP coalescing groups frames differently
                    # run to run, and an nth=N schedule counted in
                    # chunks would journal a different tokens_at_death
                    # each time (the journal's replay-determinism
                    # contract)
                    if self._flt_midstream is not None \
                            and not journal.closed:
                        try:
                            self._flt_midstream.fire()
                        except FaultError:
                            raise _BackendLost() from None
        except (OSError, asyncio.TimeoutError) as e:
            if journal.closed:
                return  # every frame delivered; the EOF hiccup is moot
            raise _BackendLost() from e
        if not journal.closed:
            # the body ended with no done/error frame: the backend gave
            # up on this stream even if the socket closed politely —
            # as dead, for the client's purposes, as a reset (over the
            # replicas' close-delimited HTTP/1.0 bodies, a crash reads
            # exactly so)
            raise _BackendLost()

    @staticmethod
    def _observe_frame(journal: _StreamJournal, frame: bytes) -> None:
        """Feed one relayed SSE frame into the journal (single writer:
        the task pumping this stream). A frame we cannot parse is
        ignored."""
        for line in frame.split(b"\n"):
            if not line.startswith(b"data: "):
                continue
            try:
                evt = json.loads(line[len(b"data: "):])
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            if isinstance(evt, dict):
                journal.observe(evt)

    async def _error_frame(self, out: StreamResponse, code: str,
                           message: str) -> None:
        """End a client stream with the structured error frame (the
        native SSE shape the replicas themselves emit on engine death)
        — a resume that cannot happen must be VISIBLE, never a silent
        truncation that reads like a short completion."""
        evt = {"error": {"code": code, "message": message}}
        try:
            await out.write(
                f"data: {json.dumps(evt)}\n\n".encode()
            )
        except _ClientGone:
            pass  # nobody left to tell

    @staticmethod
    def _max_new(journal: _StreamJournal) -> int:
        try:
            return int(journal.body.get("max_new", 64) or 0)
        except (TypeError, ValueError):
            return 0

    async def _resume_stream(self, dead: Replica, request,
                             out: StreamResponse,
                             journal: _StreamJournal,
                             headers: dict, tl=None) -> "Replica | None":
        """The fleet tier's recovery guarantee: a replica died under a
        journaled stream — resubmit the request through the native
        resume seam (emitted tokens folded into the prompt) to the next
        ring candidate and splice the continuation into the SAME client
        response, zero re-emitted tokens. Chained deaths loop (each
        charges the fleet budget for ITS replica); past the budget the
        stream ends with the structured error frame. Returns the
        replica that finished the stream, or None when no LIVE replica
        finished it (the error frame, or a synthesized done after a
        tokens-complete death)."""
        max_new = self._max_new(journal)
        while True:
            tokens_at_death = len(journal.tokens)
            self.fleet.note_failure(dead)
            # the dead replica's relay gets its outcome recorded (once
            # per death observation)
            self._count(dead, "died_midstream")
            self._maybe_promote()
            if not self._fleet_budget.charge(dead):
                self._resume_failures += 1
                self.journal.emit("budget_exhausted", replica=dead.rid,
                                  tokens_at_death=tokens_at_death)
                if tl is not None:
                    tl.error_code = "fleet_budget_exhausted"
                log.warning(
                    "mid-stream replica death past the fleet restart "
                    "budget; ending stream with an error frame",
                    extra={"fields": {"replica": dead.rid,
                                      **self._fleet_budget.stats()}},
                )
                await self._error_frame(
                    out, "fleet_budget_exhausted",
                    f"replica {dead.rid!r} died mid-stream and the "
                    "fleet restart budget is exhausted; partial output "
                    f"({len(journal.tokens)} tokens) was delivered",
                )
                return None
            if max_new and len(journal.tokens) >= max_new:
                # the death ate only the done frame — every budgeted
                # token was already delivered. Synthesize a bare done
                # instead of resubmitting an empty resume.
                self._resumes += 1
                if tl is not None:
                    tl.resumes += 1
                if self.metrics is not None:
                    self.metrics.stream_resumes.inc()
                self.journal.emit(
                    "stream_resume", source=dead.rid, target=None,
                    tokens_at_death=tokens_at_death, synthesized_done=True,
                )
                try:
                    await out.write(b'data: {"done": true}\n\n')
                except _ClientGone:
                    pass
                # no live finisher: the corpse must NOT be handed back
                # as this stream's final replica
                return None
            raw = journal.resume_body()
            resp = None
            target = None
            t_scan = time.monotonic()
            refused: set[str] = set()
            while resp is None:
                # scan the ring candidates; a fully-refusing fleet is
                # RETRIED within resume_timeout_s — the survivor may be
                # momentarily overloaded (429) or a promotion may be a
                # poll-tick away
                wait = None
                order, _ = self._pick(journal.key)
                candidates = [r for r in order if r is not dead]
                usable = [r for r in candidates if r.rid not in refused]
                if candidates and not usable:
                    # every reachable candidate REFUSED the resume at
                    # the app level: deterministic, waiting can't help
                    break
                for rep in usable:
                    self._failovers += 1
                    if tl is not None:
                        tl.failovers += 1
                    if self.metrics is not None:
                        self.metrics.failovers.inc()
                    try:
                        r = await self._open_backend(
                            f"{rep.url}{request.path}", raw, headers
                        )
                    except _Unreachable:
                        self.fleet.note_failure(rep)
                        self._maybe_promote()
                        continue
                    if r.status == 429:
                        # can't forward a status mid-stream: cool the
                        # replica down and try the next candidate
                        await self._drop(r)
                        ra = parse_retry_after(
                            r.headers.get("Retry-After"), default=1.0
                        )
                        rep.cooldown_until = time.monotonic() + ra
                        wait = ra if wait is None else min(wait, ra)
                        continue
                    ctype = r.headers.get("Content-Type", "")
                    if r.status != 200 or not ctype.startswith(
                        "text/event-stream"
                    ):
                        # a resume the replica refused: only a 5xx is
                        # dead-engine evidence — a 4xx is an app-level
                        # answer PROVING the engine alive, it just can't
                        # continue this stream, ever (skip it in later
                        # scans instead of re-asking)
                        await self._drop(r)
                        if r.status >= 500:
                            self.fleet.note_failure(rep)
                        else:
                            self.fleet.note_success(rep)
                            refused.add(rep.rid)
                        continue
                    resp, target = r, rep
                    break
                if resp is not None:
                    break
                if time.monotonic() - t_scan > self.resume_timeout_s:
                    break
                await asyncio.sleep(min(wait if wait is not None else 0.1,
                                        1.0))
            if resp is None:
                self._resume_failures += 1
                self.journal.emit("resume_failed", replica=dead.rid,
                                  tokens_at_death=tokens_at_death)
                if tl is not None:
                    tl.error_code = "resume_failed"
                await self._error_frame(
                    out, "resume_failed",
                    f"replica {dead.rid!r} died mid-stream and no "
                    "candidate could resume the request; partial output "
                    f"({len(journal.tokens)} tokens) was delivered",
                )
                return None
            self._count_resume(dead, target)
            self.journal.emit("stream_resume", source=dead.rid,
                              target=target.rid,
                              tokens_at_death=tokens_at_death)
            if tl is not None:
                tl.resumes += 1
                # the resume gap closes here: the continuation's bytes
                # are about to flow from the new replica
                tl.relay_on(target.rid)
            target.inflight += 1
            if self.metrics is not None:
                self.metrics.inflight.labels(target.rid).set(target.inflight)
            try:
                await self._pump_sse(resp, out, journal)
            except _BackendLost:
                # the continuation's replica died too: charge ITS death
                # and loop — the journal kept growing, so the next
                # resume starts exactly where this one ended
                resp.close()
                if tl is not None:
                    tl.advance("resume_gap")
                dead = target
                continue
            except _ClientGone:
                # the client vanished mid-continuation: cancel upstream
                # (hard close) and stop — nobody left to stream to
                resp.close()
                return target
            except BaseException:
                resp.close()
                raise
            finally:
                target.inflight -= 1
                if self.metrics is not None:
                    self.metrics.inflight.labels(target.rid).set(
                        target.inflight
                    )
            self.fleet.note_success(target)
            self._count(target, "resumed")
            resp.release()
            return target

    @staticmethod
    async def _drop(resp) -> None:
        """Read an answer that will not be relayed, and let it go."""
        try:
            await resp.read()
        except OSError:
            pass
        resp.release()

    def _count_resume(self, dead: Replica, target: Replica) -> None:
        self._resumes += 1
        if self.metrics is not None:
            self.metrics.stream_resumes.inc()
        log.warning(
            "resumed mid-stream after replica death",
            extra={"fields": {"replica": target.rid, "dead": dead.rid,
                              "resumed_on": target.rid,
                              "resumes": self._resumes}},
        )

    async def _open_attempt(self, rep: Replica, request, raw: bytes,
                            headers: dict):
        """The head of one dispatch attempt (shared by both relays):
        the ``router.connect`` fault, the POST, and a 429 turned into
        _Overloaded for the failover loop."""
        if self._flt_connect is not None:
            try:
                self._flt_connect.fire()
            except FaultError as e:
                # injected connection failure: the failover loop moves
                # to the next ring candidate, like a real refusal
                raise _Unreachable(str(e)) from None
        resp = await self._open_backend(f"{rep.url}{request.path}", raw,
                                        headers)
        if resp.status == 429:
            try:
                body = await resp.read()
            except OSError:
                body = b""
            resp.release()
            ra = parse_retry_after(
                resp.headers.get("Retry-After"), default=1.0
            )
            raise _Overloaded(
                body, max(1, int(math.ceil(ra))),
                resp.headers.get("Content-Type", "application/json")
                .split(";")[0],
            )
        return resp

    async def _relay(self, rep: Replica, request,
                     raw: bytes, headers: dict,
                     journal: "_StreamJournal | None" = None,
                     tl=None):
        """One dispatch attempt: forward the body verbatim, relay the
        response (SSE streamed frame-by-frame, JSON in one piece).
        Raises _Unreachable/_Overloaded for the failover loop; anything
        past response headers is final — except a journaled stream's
        mid-relay backend death, which the resume path splices over."""
        resp = await self._open_attempt(rep, request, raw, headers)
        try:
            ctype = resp.headers.get("Content-Type", "")
            if tl is not None:
                # headers arrived and the status is an answer (not a
                # 429 hop): the candidate scan ends, relay bytes flow
                tl.relay_on(rep.rid)
            if ctype.startswith("text/event-stream"):
                out = _sse_response()
                await out.prepare(request)
                # which replica fed the liveness ledger for this stream
                # (the resume path may hand it to another replica; None
                # = the stream ended on an error frame)
                out.router_final_rep = rep
                try:
                    await self._pump_sse(resp, out, journal)
                except _BackendLost:
                    resp.close()
                    if tl is not None:
                        # the resume gap opens at the observed death
                        # and closes when a continuation's relay starts
                        tl.advance("resume_gap")
                    out.router_final_rep = await self._resume_stream(
                        rep, request, out, journal, headers, tl=tl
                    )
                    return out
                except _ClientGone:
                    # the CLIENT vanished mid-relay: close the backend
                    # connection HARD so the replica sees the disconnect
                    # and cancels the generation — no resume, no retry
                    resp.close()
                    return out
                resp.release()
                return out
            body = await resp.read()
            resp.release()
            return _plain(body, resp.status, ctype)
        except BaseException:
            # a backend lost mid-body, or cancellation mid-relay: close the backend connection HARD
            # so the replica sees the disconnect and cancels the
            # generation
            resp.close()
            raise

    # --- disaggregated prefill/decode (KV-page transfer) ------------------

    def _count_kv_transfer(self, outcome: str, pages: int,
                           ms: "float | None") -> None:
        self._kv_transfers[outcome] = (
            self._kv_transfers.get(outcome, 0) + 1
        )
        self._kv_transfer_pages += int(pages)
        if ms is not None:
            # only attempts that MOVED (or tried to move) pages feed
            # the latency record; completed_on_prefill never transfers
            self._kv_transfer_ms.append(round(float(ms), 3))
        if len(self._kv_transfer_ms) > 4096:
            # keep the recent half: percentiles of recent transfers,
            # not the process's whole history
            del self._kv_transfer_ms[:2048]
        if self.metrics is not None:
            self.metrics.kv_transfers.labels(outcome).inc()

    async def _pump_first_token(self, resp, out: StreamResponse,
                                journal: _StreamJournal) -> None:
        """Relay the prefill leg until a token frame proves the request
        is decoding (export is only defined past prefill). Every
        COMPLETE frame in the triggering network chunk is relayed and
        journaled exactly like _pump_sse; a partial trailing frame is
        abandoned with the connection — its token is inside the
        export's atomic snapshot and the gap synthesis re-emits it.
        Raises _BackendLost when the body ends before a token or a
        close frame (the normal resume trigger)."""
        buf = b""
        try:
            async for chunk in resp.iter_any():
                buf += chunk
                while b"\n\n" in buf:
                    frame, buf = buf.split(b"\n\n", 1)
                    await out.write(frame + b"\n\n")
                    self._observe_frame(journal, frame)
                if journal.tokens or journal.closed:
                    return
        except (OSError, asyncio.TimeoutError) as e:
            if journal.closed:
                return
            raise _BackendLost() from e
        if not journal.closed:
            raise _BackendLost()

    async def _synthesize_gap(self, out: StreamResponse,
                              journal: _StreamJournal, exp: dict) -> None:
        """The export's engine-thread snapshot can surface tokens the
        relay never read (the engine flushes in-flight pipelined decode
        before snapshotting, and the relay stops at the first token):
        those tokens are part of the stream the client was promised.
        Emit their frames exactly as the replica would have — same JSON
        shape, logprob field only when the request asked for it — and
        journal them so any later resume starts from the full record."""
        toks = exp.get("resume_out") or []
        lps = exp.get("resume_logprobs") or []
        want_lp = bool(journal.body.get("logprobs"))
        for i in range(len(journal.tokens), len(toks)):
            t = int(toks[i])
            lp = float(lps[i]) if i < len(lps) else 0.0
            evt = {"token": t, "logprob": lp}
            journal.observe(evt)
            wire = evt if want_lp else {"token": t}
            await out.write(
                f"data: {json.dumps(wire)}\n\n".encode()
            )

    async def _pump_leg(self, rep: Replica, resp, request,
                        out: StreamResponse,
                        journal: _StreamJournal, headers: dict,
                        tl=None) -> "Replica | None":
        """Pump one continuation leg (the decode worker, or a plain-
        resume fallback target) to completion, with the full recovery
        story: a mid-leg backend death hands off to _resume_stream
        (a REAL death — it charges the fleet budget and feeds the
        liveness ledger like any other). Returns the replica that
        finished the stream, or None when the error-frame path ended
        it."""
        if tl is not None:
            tl.relay_on(rep.rid)
        rep.inflight += 1
        if self.metrics is not None:
            self.metrics.inflight.labels(rep.rid).set(rep.inflight)
        try:
            await self._pump_sse(resp, out, journal)
        except _BackendLost:
            resp.close()
            if tl is not None:
                tl.advance("resume_gap")
            return await self._resume_stream(
                rep, request, out, journal, headers, tl=tl
            )
        except _ClientGone:
            resp.close()
            return rep
        except BaseException:
            resp.close()
            raise
        finally:
            rep.inflight -= 1
            if self.metrics is not None:
                self.metrics.inflight.labels(rep.rid).set(rep.inflight)
        self.fleet.note_success(rep)
        self._count(rep, "ok")
        resp.release()
        return rep

    async def _splice_resume(self, request, out: StreamResponse,
                             journal: _StreamJournal, headers: dict,
                             tl=None) -> "Replica | None":
        """The transfer-failure degrade: resubmit the journal's PLAIN
        resume body (no kv_pages — the target re-prefills through the
        fold) and splice the continuation. One pass over the
        decode-capable candidates; if none answers, the stream ends
        with the structured error frame — a failed transfer must be a
        performance event, never a dropped stream."""
        max_new = self._max_new(journal)
        if max_new and len(journal.tokens) >= max_new:
            # the export surfaced every budgeted token: close the
            # stream here (the _resume_stream synthesized-done rule)
            try:
                await out.write(b'data: {"done": true}\n\n')
            except _ClientGone:
                pass
            return None
        raw = journal.resume_body()
        # role="decode" prefers decode-capable replicas, but the filter
        # falls away when none is live — then even the SOURCE prefill
        # replica is a valid target (it retired/cancelled the original,
        # and a re-prefill resume is admissible anywhere)
        order, _ = self._pick(journal.key, role="decode")
        for rep in order:
            try:
                r = await self._open_backend(
                    f"{rep.url}{request.path}", raw, headers
                )
            except _Unreachable:
                self.fleet.note_failure(rep)
                self._maybe_promote()
                continue
            if r.status == 429:
                await self._drop(r)
                ra = parse_retry_after(
                    r.headers.get("Retry-After"), default=1.0
                )
                rep.cooldown_until = time.monotonic() + ra
                continue
            ctype = r.headers.get("Content-Type", "")
            if r.status != 200 or not ctype.startswith("text/event-stream"):
                await self._drop(r)
                if r.status >= 500:
                    self.fleet.note_failure(rep)
                else:
                    self.fleet.note_success(rep)
                continue
            return await self._pump_leg(
                rep, r, request, out, journal, headers, tl=tl
            )
        self._resume_failures += 1
        self.journal.emit("resume_failed", replica=None,
                          tokens_at_death=len(journal.tokens))
        if tl is not None:
            tl.error_code = "resume_failed"
        await self._error_frame(
            out, "resume_failed",
            "KV transfer failed and no candidate could resume the "
            f"request; partial output ({len(journal.tokens)} tokens) "
            "was delivered",
        )
        return None

    async def _export(self, rep: Replica, eid: str,
                      headers: dict) -> "dict | None":
        """``POST /v1/kv/export/{eid}`` on the prefill replica: its
        answer, or None when it failed in any way."""
        try:
            status, _, data = await async_http.fetch(
                "POST", f"{rep.url}/v1/kv/export/{eid}", b"", headers,
                timeout_s=max(30.0, self.connect_timeout_s),
            )
            exp = json.loads(data) if status == 200 else None
        except (OSError, asyncio.TimeoutError, ValueError):
            return None
        if not (isinstance(exp, dict)
                and isinstance(exp.get("resume_out"), list)
                and exp["resume_out"]
                and isinstance(exp.get("kv_pages"), dict)):
            return None
        return exp

    async def _kv_handoff(self, rep: Replica, src_resp,
                          request, out: StreamResponse,
                          journal: _StreamJournal, headers: dict,
                          tl=None) -> "Replica | None":
        """The transfer itself: export the request's KV pages off the
        prefill replica (which atomically retires it), synthesize any
        tokens the snapshot surfaced past the relay, and resubmit
        resume_out + kv_pages to a decode worker, splicing its stream
        into the same client response. ANY failure — export refused,
        worker unreachable, pool pressure (429 kv_pool_pressure) —
        degrades to the plain re-prefill resume; the page blob is sized
        for this exact moment, so waiting out a 429 would only stale
        it. Returns the finishing replica (None = error frame)."""
        t0 = time.monotonic()
        if tl is not None:
            # the client-perceived stall between the prefill leg's last
            # relayed byte and the decode leg's first — the disagg twin
            # of resume_gap, summed into the timeline's phases
            tl.advance("transfer_gap")
        tokens_at = len(journal.tokens)
        eid = src_resp.headers.get("X-Request-Id")
        with self.tracer.span(
            "kv_transfer", component="router", source=rep.rid,
            tokens_at_transfer=tokens_at,
        ) as span:
            exp = None
            if eid is not None:
                exp = await self._export(rep, eid, headers)
            # the export retired the request (or failed — then this
            # disconnect cancels it server-side and the fallback
            # re-prefills); either way the source stream is finished.
            # Closed only AFTER the export returns: closing first would
            # race the disconnect-cancel against the snapshot.
            src_resp.close()
            target = r2 = None
            pages = 0
            if exp is not None:
                pages = int(exp["kv_pages"].get("n_pages", 0))
                try:
                    await self._synthesize_gap(out, journal, exp)
                except _ClientGone:
                    return None
                body2 = dict(journal.body)
                body2["resume_out"] = [int(t) for t in exp["resume_out"]]
                body2["resume_logprobs"] = [
                    float(x) for x in (exp.get("resume_logprobs") or ())
                ]
                body2["kv_pages"] = exp["kv_pages"]
                raw2 = json.dumps(body2).encode()
                order, _ = self._pick(journal.key, role="decode")
                for rep2 in order:
                    if rep2 is rep:
                        continue  # the source just dropped these pages
                    try:
                        r2 = await self._open_backend(
                            f"{rep2.url}{request.path}", raw2, headers
                        )
                    except _Unreachable:
                        self.fleet.note_failure(rep2)
                        self._maybe_promote()
                        continue
                    ctype = r2.headers.get("Content-Type", "")
                    if r2.status != 200 or not ctype.startswith(
                        "text/event-stream"
                    ):
                        await self._drop(r2)
                        if r2.status == 429:
                            rep2.cooldown_until = (
                                time.monotonic() + parse_retry_after(
                                    r2.headers.get("Retry-After"),
                                    default=1.0,
                                )
                            )
                        elif r2.status >= 500:
                            self.fleet.note_failure(rep2)
                        else:
                            self.fleet.note_success(rep2)
                        continue
                    target = rep2
                    break
            ms = (time.monotonic() - t0) * 1e3
            if target is None:
                self._count_kv_transfer("fallback", 0, ms)
                self.journal.emit(
                    "kv_transfer", source=rep.rid, target=None,
                    outcome="fallback", tokens_at_transfer=tokens_at,
                )
                if hasattr(span, "set"):
                    span.set(outcome="fallback")
                log.warning(
                    "kv transfer failed; degrading to re-prefill resume",
                    extra={"fields": {"replica": rep.rid,
                                      "tokens_at_transfer": tokens_at}},
                )
                return await self._splice_resume(
                    request, out, journal, headers, tl=tl
                )
            self._count_kv_transfer("ok", pages, ms)
            self.journal.emit(
                "kv_transfer", source=rep.rid, target=target.rid,
                outcome="ok", pages=pages, tokens_at_transfer=tokens_at,
            )
            if hasattr(span, "set"):
                span.set(outcome="ok", target=target.rid, pages=pages)
        return await self._pump_leg(
            target, r2, request, out, journal, headers, tl=tl
        )

    async def _relay_disagg(self, rep: Replica, request,
                            raw: bytes, headers: dict,
                            journal: "_StreamJournal | None" = None,
                            tl=None):
        """One disaggregated dispatch attempt (the _relay substitute
        the role-aware dispatch loop drives): relay the prefill leg
        until the first token, then hand the stream to _kv_handoff.
        Pre-header failures raise _Unreachable/_Overloaded for the
        failover loop exactly like _relay; a prefill-leg death falls
        back to the normal resume path (re-prefill elsewhere)."""
        resp = await self._open_attempt(rep, request, raw, headers)
        try:
            ctype = resp.headers.get("Content-Type", "")
            if tl is not None:
                tl.relay_on(rep.rid)
            if not ctype.startswith("text/event-stream"):
                # an app-level answer (4xx validation, 5xx): final —
                # relayed verbatim, the dispatch postlude counts it
                body = await resp.read()
                resp.release()
                return _plain(body, resp.status, ctype)
            out = _sse_response()
            await out.prepare(request)
            out.router_final_rep = rep
            try:
                await self._pump_first_token(resp, out, journal)
            except _BackendLost:
                resp.close()
                if tl is not None:
                    tl.advance("resume_gap")
                out.router_final_rep = await self._resume_stream(
                    rep, request, out, journal, headers, tl=tl
                )
            except _ClientGone:
                resp.close()
                return out
            else:
                if journal.closed:
                    # the whole stream fit before the first transfer
                    # point (tiny max_new / instant stop hit): done —
                    # nothing to move
                    self._count_kv_transfer("completed_on_prefill", 0, None)
                    resp.release()
                else:
                    # the prefill replica did its half; the handoff
                    # owns src_resp from here (export-then-close)
                    self.fleet.note_success(rep)
                    out.router_final_rep = await self._kv_handoff(
                        rep, resp, request, out, journal, headers, tl=tl
                    )
            return out
        except BaseException:
            resp.close()
            raise

    async def _proxy_get(self, request) -> Response:
        """GET passthrough (/v1/models): any live replica's answer —
        the fleet serves ONE model, so they all agree. Cooldown AND
        drain are advisory here: both only gate new GENERATION
        admissions, and a cooling or draining replica still serves
        cheap metadata reads."""
        now = time.monotonic()
        candidates = [r for r in self.fleet.all() if r.routable(now)]
        if not candidates:
            candidates = [r for r in self.fleet.all() if r.alive]
        for rep in candidates:
            try:
                status, rhdrs, body = await async_http.fetch(
                    "GET", f"{rep.url}{request.path}",
                    timeout_s=self.connect_timeout_s,
                )
            except (OSError, asyncio.TimeoutError):
                self.fleet.note_failure(rep)
                continue
            return _plain(body, status, rhdrs.get("Content-Type", ""))
        return self._refuse(request.path, "no_replica",
                            "no live replica available")

    # --- fleet operations -------------------------------------------------

    def router_stats(self) -> dict:
        return {
            "policy": self.policy,
            "requests": self._requests,
            "affinity_hits": self._affinity_hits,
            "adapter_requests": dict(self._adapter_requests),
            "failovers": self._failovers,
            "promotions": self._promotions,
            "resumes": self._resumes,
            "resume_failures": self._resume_failures,
            "journaled": self._journaled,
            "unjournaled": self._unjournaled,
            "fleet_budget": self._fleet_budget.stats(),
            "refused": dict(self._refused),
            "outcomes": dict(self._outcomes),
            "journal": self.journal.stats(),
            "kv_transfers": dict(self._kv_transfers),
            "kv_transferred_pages": self._kv_transfer_pages,
            "kv_transfer_ms": list(self._kv_transfer_ms),
            "roles": (
                {r.rid: r.role for r in self.fleet.all()}
                if self._roles_on else {}
            ),
            "timelines": (
                self._recorder.stats() if self._recorder is not None
                else None
            ),
        }

    def fleet_stats(self, include_router: bool = True) -> dict:
        """THE fleet-state snapshot: per-replica state, fleet tallies,
        the admitting count and (by default) the router's own counters,
        built in one pass. Both health handlers read through this
        single accessor: handlers never recompute per-replica state
        inline from registry objects the health poller mutates.
        ``include_router=False`` skips the router-counter block for the
        LB liveness probe, which only reads the snapshot tallies."""
        snap = self.fleet.snapshot()
        snap["admitting"] = sum(
            1 for r in self.fleet.active() if r.alive and not r.draining
        )
        if include_router:
            snap["router"] = self.router_stats()
        return snap

    async def _health(self, request) -> Response:
        """The router's own liveness (LB probes): up as long as at
        least one replica can ADMIT (alive and not draining) — a fleet
        mid-rolling-drain that refuses every submit must fail the
        probe, not smile at it."""
        snap = self.fleet_stats(include_router=False)
        return json_response(
            {"router": True, "alive": snap["admitting"] > 0,
             "policy": self.policy,
             "replicas": snap["total"], "live": snap["live"],
             "admitting": snap["admitting"], "draining": snap["draining"]},
            status=200 if snap["admitting"] else 503,
        )

    async def _fleet_health(self, request) -> Response:
        return json_response(self.fleet_stats())

    async def _drain_wait(self, rep: Replica) -> dict:
        """The drain wait shared by POST /fleet/drain and the rolling
        restart: router-side in-flight zero AND the replica's own
        health showing no admitted work (clients that submitted before
        the drain may still be decoding). The caller has already set
        ``rep.draining``."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < self.drain_timeout_s:
            if rep.inflight == 0:
                h = await self._probe_health(rep)
                if h is not None and not (
                    h.get("active", 0) or h.get("prefilling", 0)
                    or h.get("queued", 0)
                ):
                    secs = time.monotonic() - t0
                    log.info(
                        "replica drained",
                        extra={"fields": {"replica": rep.rid,
                                          "drain_seconds": round(secs, 3)}},
                    )
                    return {"drained": True, "drain_seconds": round(secs, 4)}
                if h is None and not rep.alive:
                    # nothing in flight and the replica is gone: as
                    # drained as it will ever be (the restart case)
                    return {"drained": True, "unreachable": True,
                            "drain_seconds": round(
                                time.monotonic() - t0, 4)}
            await asyncio.sleep(0.05)
        return {"drained": False,
                "drain_seconds": round(time.monotonic() - t0, 4)}

    def _unknown(self, rid: str) -> Response:
        return json_response(
            {"error": f"unknown replica {rid!r}",
             "replicas": self.fleet.ids()},
            status=404,
        )

    async def _drain(self, request) -> Response:
        rid = request.match_info["replica"]
        rep = self.fleet.get(rid)
        if rep is None:
            return self._unknown(rid)
        refusal = self.fleet.removal_empties_role(rep)
        if refusal is not None:
            # a specialized fleet must never drain itself into a state
            # where one side of the prefill/decode split has no server
            self.journal.emit("drain_refused", replica=rid,
                              reason="role_empty")
            return json_response(
                {"error": refusal, "code": "role_empty"}, status=409
            )
        rep.draining = True
        self.journal.emit("drain", replica=rid)
        log.info("draining replica", extra={"fields": {"replica": rid}})
        res = await self._drain_wait(rep)
        self.journal.emit("drain_done", replica=rid,
                          drained=res["drained"])
        return json_response(
            {"replica": rid, "draining": True, **res},
            status=200 if res["drained"] else 504,
        )

    async def _wait_restart(self, rep: Replica, timeout_s: float) -> bool:
        """Wait for a NEW process behind the replica's address:
        ``uptime_s`` on /v1/health resetting below its pre-drain value
        (the restart-detection contract the replicas export for
        exactly this)."""
        before = (rep.health or {}).get("uptime_s")
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            h = await self._probe_health(rep)
            if h is not None:
                up = h.get("uptime_s")
                if up is not None and (before is None or up < before):
                    return True
            await asyncio.sleep(min(0.2, max(self.health_interval_s, 0.02)))
        return False

    async def _rolling_restart(self, request) -> Response:
        """POST /fleet/rolling-restart: sequence drain -> restart-wait ->
        undrain across every active replica, one at a time — the
        weight-update maintenance cycle as ONE fleet operation. Each
        replica stops taking new work (spilling it to the others),
        finishes every in-flight stream (zero drops, zero from-scratch
        retries), optionally waits for the operator's restart to show
        (a fresh ``uptime_s``; ``wait_restart_s`` in the JSON body,
        default 0 = don't wait), then resumes admission before the next
        replica drains. 504 when any drain times out (that replica is
        undrained and the cycle continues, so a wedge degrades to a
        partial cycle, not a half-drained fleet)."""
        body: dict = {}
        if request.body:
            try:
                body = request.json()
            except ValueError:
                return json_response({"error": "body must be JSON"},
                                     status=400)
        try:
            wait_restart_s = float(body.get("wait_restart_s", 0.0) or 0.0)
        except (TypeError, ValueError, AttributeError):
            return json_response(
                {"error": "wait_restart_s must be a number"}, status=400
            )
        targets = [r for r in self.fleet.active() if r.alive]
        log.info(
            "rolling restart started",
            extra={"fields": {"replicas": [r.rid for r in targets],
                              "wait_restart_s": wait_restart_s}},
        )
        self.journal.emit("rolling_restart",
                          replicas=[r.rid for r in targets])
        results: dict = {}
        completed = True
        for rep in targets:
            refusal = self.fleet.removal_empties_role(rep)
            if refusal is not None:
                # a disaggregated fleet too small to cover a role
                # one-down skips that replica instead of serving a
                # role-less window mid-cycle
                self.journal.emit("drain_refused", replica=rep.rid,
                                  reason="role_empty")
                results[rep.rid] = {"drained": False,
                                    "refused": "role_empty"}
                completed = False
                continue
            rep.draining = True
            self.journal.emit("rolling_drain", replica=rep.rid)
            res = await self._drain_wait(rep)
            if res["drained"] and wait_restart_s > 0:
                res["restarted"] = await self._wait_restart(
                    rep, wait_restart_s
                )
                completed = completed and res["restarted"]
            rep.draining = False
            self.journal.emit("rolling_undrain", replica=rep.rid,
                              drained=res["drained"])
            results[rep.rid] = res
            completed = completed and res["drained"]
        self.journal.emit("rolling_restart_done", completed=completed)
        return json_response(
            {"replicas": results, "completed": completed},
            status=200 if completed else 504,
        )

    async def _undrain(self, request) -> Response:
        rid = request.match_info["replica"]
        rep = self.fleet.get(rid)
        if rep is None:
            return self._unknown(rid)
        rep.draining = False
        self.journal.emit("undrain", replica=rid)
        log.info("undrained replica", extra={"fields": {"replica": rid}})
        return json_response({"replica": rid, "draining": False})

    async def _metrics(self, request) -> Response:
        return Response(self.registry.render().encode(),
                        content_type=CONTENT_TYPE_CLASSIC)

    # --- observability ----------------------------------------------------

    async def _fan_out_get(
        self, path: str, headers: "dict | None" = None
    ) -> "list[tuple[str, int | None, str | None]]":
        """Concurrently GET ``path`` from every registered replica ->
        ``[(rid, status, body_text)]`` in registry order. ``status``
        None = network failure (timeout/refused); ``connect_timeout_s``
        bounds each exchange whole. Concurrency is the point: a fleet
        with several dead replicas must cost ONE connect timeout per
        pass, not their sum — a sequential scrape would blow a
        Prometheus scrape deadline on the survivors' behalf."""

        async def one(rep: Replica):
            try:
                status, _, body = await async_http.fetch(
                    "GET", f"{rep.url}{path}", headers=headers,
                    timeout_s=self.connect_timeout_s,
                )
                return rep.rid, status, body.decode()
            except (OSError, asyncio.TimeoutError, UnicodeDecodeError):
                return rep.rid, None, None

        return list(await asyncio.gather(
            *(one(rep) for rep in self.fleet.all())
        ))

    async def _fleet_trace_one(self, request) -> Response:
        """``GET /fleet/debug/traces/{id}``: pull the trace's span
        fragments from every replica's ``/debug/traces/{id}`` plus the
        router's own ring and stitch them into ONE Perfetto document —
        one process row per replica, the merge summary (per-track span
        counts, orphan fragments, unreachable replicas) under the
        ``fleet`` key."""
        tid = request.match_info["trace_id"]
        fragments: list = []
        own = self.tracer.get_trace(tid)
        if own is not None:
            fragments.append(("router", own))
        unreachable: list[str] = []
        for rid, status, text in await self._fan_out_get(
            f"/debug/traces/{tid}"
        ):
            if status is None:
                # a dead replica's fragments died with it: the stitch
                # reports the hole instead of failing the whole fetch
                unreachable.append(rid)
                continue
            if status == 404:
                continue  # that replica never saw the trace
            if status != 200:
                # an ERRORING replica (500 behind a live socket, a 400)
                # is a hole in the stitch like a dead one — reported,
                # never a silently narrowed trace
                unreachable.append(rid)
                continue
            try:
                payload = json.loads(text)
            except ValueError:
                unreachable.append(rid)
                continue
            fragments.append((rid, spans_from_chrome(payload)))
        stitched = stitched_trace_payload(fragments)
        if stitched is None:
            return json_response(
                {"error": "trace not in any replica's buffer",
                 "unreachable": unreachable},
                status=404,
            )
        stitched["fleet"]["unreachable"] = unreachable
        return json_response(stitched)

    async def _fleet_metrics(self, request) -> Response:
        """``GET /fleet/metrics``: scrape every replica's ``/metrics``,
        re-label each series with ``replica="<id>"``, and append the
        fleet aggregates. Content negotiation forwards: an OpenMetrics
        scraper gets OpenMetrics from the replicas (exemplars intact)
        and back out; everyone else gets the classic text format."""
        openmetrics = OPENMETRICS_ACCEPT in request.headers.get("Accept", "")
        headers = (
            {"Accept": "application/openmetrics-text; version=1.0.0"}
            if openmetrics else {}
        )
        scrapes: list = []
        errors: list[str] = []
        for rid, status, text in await self._fan_out_get(
            "/metrics", headers=headers
        ):
            if status != 200:
                errors.append(rid)
                continue
            scrapes.append((rid, text))
        body = federate_metrics(scrapes, openmetrics=openmetrics,
                                scrape_errors=errors)
        return Response(body.encode(), content_type=(
            CONTENT_TYPE_OPENMETRICS if openmetrics
            else CONTENT_TYPE_CLASSIC))

    async def _debug_traces(self, request) -> Response:
        """The router's OWN trace ring, accepting the same
        ``?limit=``/``?since=`` query surface as the replicas' (shared
        ``obs/http.parse_trace_query``; 400 on garbage, like them)."""
        try:
            limit, since = parse_trace_query(request.query)
        except ValueError as e:
            return json_response({"error": str(e)}, status=400)
        return json_response(
            traces_payload(self.tracer, limit=limit, since_us=since)
        )

    async def _debug_trace_one(self, request) -> Response:
        payload = trace_detail_payload(
            self.tracer, request.match_info["trace_id"]
        )
        if payload is None:
            return json_response({"error": "trace not in buffer"},
                                 status=404)
        return json_response(payload)

    async def _fleet_events(self, request) -> Response:
        """``GET /fleet/events``: the journal, oldest-first; ``?since=``
        (a seq) + ``?limit=`` page it forward through the same
        parse_trace_query surface as the trace planes (400 on garbage).
        The device-plugin journals join here with ``--plugins``
        (ROADMAP A.14)."""
        try:
            limit, since = parse_trace_query(
                request.query, since_desc="event seq"
            )
        except ValueError as e:
            return json_response({"error": str(e)}, status=400)
        return json_response(
            self.journal.events_payload(limit=limit, since=since))

    def _timelines_off(self) -> Response:
        return json_response(
            {"error": "router timelines disabled (start without "
                      "--timelinesOff)"},
            status=404,
        )

    async def _fleet_requests(self, request) -> Response:
        if self._recorder is None:
            return self._timelines_off()
        return json_response(self._recorder.request_stats())

    async def _fleet_request_one(self, request) -> Response:
        if self._recorder is None:
            return self._timelines_off()
        try:
            rid = int(request.match_info["rid"])
        except ValueError:
            return json_response(
                {"error": "rid must be an integer"}, status=400
            )
        record = self._recorder.get(rid)
        if record is None:
            return json_response(
                {"error": "request not in the timeline buffer"}, status=404
            )
        return json_response(record)


def build_parser():
    import argparse

    parser = argparse.ArgumentParser(prog="torch-replica-router")
    parser.add_argument("--replicas", required=True,
                        help="comma list of replica backends: "
                        "[id=]http://host:port,... (id defaults to "
                        "host:port, matching the replica's own "
                        "--replicaId default)")
    parser.add_argument("--port", type=int, default=8100)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--policy", default="affinity",
                        choices=["affinity", "rr"],
                        help="'affinity' (default) routes each request's "
                        "bucket-aligned token-prefix path onto a "
                        "consistent-hash ring with bounded-load spill, "
                        "so shared-prefix tenants land where their "
                        "prefix cache lives; 'rr' round-robins")
    parser.add_argument("--loadFactor", type=float, default=1.25,
                        help="bounded-load spill: a ring candidate "
                        "already carrying more than this times the "
                        "fleet's mean in-flight count spills to the "
                        "next candidate")
    parser.add_argument("--healthIntervalS", type=float, default=1.0,
                        help="replica /v1/health poll cadence")
    parser.add_argument("--deadAfter", type=int, default=3,
                        help="consecutive health/proxy failures before a "
                        "replica is routed around (any success revives)")
    parser.add_argument("--drainTimeoutS", type=float, default=120.0,
                        help="POST /fleet/drain/{replica} gives up (504, "
                        "drained:false) after this long")
    parser.add_argument("--warmSpares", type=int, default=0,
                        help="hold the LAST N --replicas entries off the "
                        "ring as warm standbys: registered and health-"
                        "polled but unrouted, promoted into the ring "
                        "(affinity keys remapped) when an active "
                        "replica is marked dead — surfaced on "
                        "/fleet/health and gpu_router_promotions_total")
    parser.add_argument("--fleetRestartBudget", type=int, default=3,
                        help="mid-stream replica deaths the router may "
                        "resume per rolling --fleetRestartWindowS (one "
                        "charge per replica DEATH, however many streams "
                        "it carried); past it (or with 0) streams end "
                        "with the structured error frame — never a "
                        "silent truncation")
    parser.add_argument("--fleetRestartWindowS", type=float, default=300.0,
                        help="rolling window for --fleetRestartBudget")
    parser.add_argument("--promptBuckets", default="",
                        help="comma list of prompt-bucket boundaries "
                        "for the affinity key (default: the batcher's "
                        "DEFAULT_PROMPT_BUCKETS ladder). MUST match the "
                        "replicas' effective ladder — custom buckets or "
                        "a small --maxLen trimming it — or affinity "
                        "keys cut where no cache ever promotes")
    parser.add_argument("--adapterNames", default="",
                        help="comma list of LoRA adapter names the "
                        "replicas serve: a request selecting a listed "
                        "adapter folds it into the affinity key so the "
                        "adapter's traffic lands where its stacks are "
                        "already resident")
    parser.add_argument("--headerTimeoutS", type=float, default=300.0,
                        help="bound the header phase of a dispatch so a "
                        "wedged replica (socket accepts, never answers) "
                        "fails over like a connection failure within "
                        "the timeout; 0 restores unbounded")
    parser.add_argument("--faults", default="",
                        help="seeded fault injection (serving/faults.py) "
                        "for the router-side points router.connect / "
                        "router.midstream, e.g. 'router.connect:nth=2'; "
                        "also read from TPU_SERVING_FAULTS; empty = "
                        "disarmed")
    parser.add_argument("--tracing", action="store_true",
                        help="span tracing: router spans propagate to "
                        "the replicas via traceparent; the router's own "
                        "ring serves GET /debug/traces")
    parser.add_argument("--journalEvents", type=int, default=1024,
                        help="fleet event journal ring size (GET "
                        "/fleet/events)")
    parser.add_argument("--timelinesOff", action="store_true",
                        help="disable router-side request timelines + "
                        "the flight recorder (GET /fleet/debug/"
                        "requests)")
    parser.add_argument("--plugins", default="",
                        help="device-plugin control planes to federate; "
                        f"refused until the device plugin is ported "
                        f"({PLUGINS_ITEM})")
    parser.add_argument("--slowStreamMs", type=float, default=0.0,
                        help="flight-recorder SLO threshold: streams "
                        "whose router wall time reaches this are "
                        "retained alongside the always-retained "
                        "resumed/failed-over/error streams (0 = only "
                        "those)")
    parser.add_argument("--roles", default="",
                        help="disaggregated serving roles: whitespace/"
                        "semicolon-separated 'role=id,id' groups over "
                        "the --replicas ids, e.g. "
                        "'prefill=r0,r1 decode=r2'. Unlisted replicas "
                        "stay 'any'. When any role is assigned, long "
                        "prompts prefill on a prefill-capable replica "
                        "and their KV pages transfer to a decode worker "
                        "at the first token")
    parser.add_argument("--disaggMinPrompt", type=int, default=64,
                        help="prompts at least this many tokens long "
                        "take the disaggregated prefill->transfer->"
                        "decode path; only meaningful with --roles")
    return parser


def build_router(args) -> ReplicaRouter:
    """Parsed CLI flags -> a router (not yet serving), on its own
    registry. ValueError for a refused configuration."""
    if args.plugins:
        raise ValueError(
            "--plugins (device-plugin federation) waits for the port of "
            f"the device plugin ({PLUGINS_ITEM})"
        )
    buckets = None
    if args.promptBuckets:
        try:
            buckets = tuple(
                int(b) for b in args.promptBuckets.split(",") if b.strip()
            )
        except ValueError:
            raise ValueError(
                f"--promptBuckets {args.promptBuckets!r}: expected a "
                "comma list of integers"
            ) from None
    from k8s_gpu_device_plugin_torch.serving.faults import FaultPlane

    fault_plane = FaultPlane.from_cli(args.faults)
    registry = Registry()
    if args.tracing:
        from k8s_gpu_device_plugin_torch.obs.prom import SpanMetrics
        from k8s_gpu_device_plugin_torch.obs.trace import configure

        SpanMetrics(registry).install(configure(enabled=True))
    fleet = FleetRegistry.from_spec(args.replicas, dead_after=args.deadAfter)
    return ReplicaRouter(
        fleet, host=args.host, port=args.port, policy=args.policy,
        prompt_buckets=buckets,
        load_factor=args.loadFactor,
        health_interval_s=args.healthIntervalS,
        drain_timeout_s=args.drainTimeoutS,
        header_timeout_s=args.headerTimeoutS,
        warm_spares=args.warmSpares,
        fleet_restart_budget=args.fleetRestartBudget,
        fleet_restart_window_s=args.fleetRestartWindowS,
        journal_events=args.journalEvents,
        timelines=not args.timelinesOff,
        slow_stream_ms=args.slowStreamMs,
        registry=registry, metrics=RouterMetrics(registry),
        faults=fault_plane,
        roles=args.roles or None,
        disagg_min_prompt=args.disaggMinPrompt,
        adapter_names=tuple(
            n.strip() for n in args.adapterNames.split(",") if n.strip()
        ),
    )


def _main(argv: list[str] | None = None) -> int:
    """CLI: route the two HTTP API surfaces across N replica backends."""
    import sys

    args = build_parser().parse_args(argv)
    try:
        router = build_router(args)
    except ValueError as e:  # a refused flag or a malformed spec
        print(f"error: {e}", file=sys.stderr)
        return 2

    async def serve():
        import signal

        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await router.run(stop)

    asyncio.run(serve())
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
