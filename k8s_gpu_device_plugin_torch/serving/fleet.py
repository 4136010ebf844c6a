"""Fleet replica registry: the bookkeeping half of the replica router.

Port of ``k8s_gpu_device_plugin_tpu/serving/fleet.py``, whole: the
router's state, free of HTTP so the routing policy is testable as plain
objects (``serving/router.py`` makes N port replicas act like one
service over it):

- :class:`Replica`: one backend engine's registry entry — its base URL,
  router-side in-flight count, drain flag, liveness bookkeeping (the
  health poller and the proxy's connection failures both feed it), the
  last ``/v1/health`` payload, and the 429 ``Retry-After`` cooldown.
- :class:`FleetRegistry`: the replica set plus the aggregate
  ``GET /fleet/health`` snapshot, roles (disaggregated prefill/decode)
  and warm spares.
- :class:`HashRing`: a consistent-hash ring over replica ids (virtual
  nodes, stable byte hashing — NOT Python's salted ``hash()``), so the
  same affinity key maps to the same replica across router restarts.
- :func:`affinity_key`: the routing key — the request's
  **bucket-aligned token-prefix path**, truncated at the largest
  ``prompt_buckets`` boundary the prompt covers. These are exactly the
  boundaries serving/prefix_cache.py promotes at, so two prompts that
  can share a cached prefix hash to the same ring point and land where
  that cache lives; bytes past the last boundary cannot be cached and
  must not split the key.
- :class:`FleetRestartBudget`: the cross-replica resume budget, one
  charge per replica death, on the supervisor's ``RollingBudget``.

Thread model: everything here is event-loop state owned by the router's
asyncio task (single-threaded, like the rest of the router) — no locks,
no cross-thread readers. Imports no torch.
"""

from __future__ import annotations

import bisect
import email.utils
import hashlib
import json
import time
from urllib.parse import urlparse

from k8s_gpu_device_plugin_torch.serving.supervisor import RollingBudget


def parse_retry_after(raw, *, default: float = 1.0,
                      max_s: float = 3600.0) -> float:
    """``Retry-After`` header value -> seconds to wait.

    RFC 9110 allows BOTH shapes — delta-seconds (``"30"``) and an
    HTTP-date (``"Tue, 04 Aug 2026 17:00:00 GMT"``); a proxy in front
    of a replica may well rewrite one into the other. Garbage (or a
    date in the past) falls back to ``default`` instead of raising —
    a malformed header from an overloaded backend must slow the client
    down, not crash it. The result is clamped to [0, ``max_s``]: a
    backend asking for a year must not wedge a retry loop."""
    if raw is None:
        return float(default)
    s = str(raw).strip()
    if not s:
        return float(default)
    import math

    try:
        secs = float(s)
    except ValueError:
        import datetime

        try:
            when = email.utils.parsedate_to_datetime(s)
        except (TypeError, ValueError):
            return float(default)
        if when is None:
            return float(default)
        if when.tzinfo is None:
            # RFC 5322 dates without a zone are rare but parseable;
            # treat them as UTC like every HTTP implementation does
            when = when.replace(tzinfo=datetime.timezone.utc)
        secs = (
            when - datetime.datetime.now(datetime.timezone.utc)
        ).total_seconds()
        if secs < 0:
            return float(default)  # already elapsed: retry now-ish
    if not math.isfinite(secs) or secs < 0:
        # NaN/inf are garbage too: NaN slips through < comparisons and
        # min(), then poisons whatever arithmetic consumes the wait
        return float(default)
    return min(float(secs), float(max_s))


def _digest(data: bytes) -> int:
    """Stable 64-bit hash (blake2b): Python's ``hash()`` is salted per
    process, which would re-deal every tenant's cache home on restart."""
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "big"
    )


def affinity_key(source, buckets: tuple[int, ...]) -> bytes | None:
    """Request -> routing key bytes (None = no affinity; balance only).

    ``source`` is whatever prefix-bearing field the surface carries:
    a token-id list (native ``prompt`` / OpenAI id-list prompts), a
    string (text prompts — byte length stands in for token length), or
    any JSON-serializable structure (chat ``messages``). The key is the
    prefix up to the largest ``buckets`` boundary the sequence reaches —
    the prefix cache's promotion ladder — so requests sharing a
    cacheable prefix share a key, and divergence past the last boundary
    (uncacheable) does not scatter them."""
    if source is None:
        return None
    if isinstance(source, (list, tuple)) and source and all(
        isinstance(t, int) and not isinstance(t, bool) for t in source
    ):
        n = len(source)
        cut = max((b for b in buckets if b <= n), default=n)
        return ",".join(str(t) for t in source[:cut]).encode()
    if isinstance(source, str):
        if not source:
            return None
        raw = source.encode()
        cut = max((b for b in buckets if b <= len(raw)), default=len(raw))
        return raw[:cut]
    try:
        raw = json.dumps(source, sort_keys=True).encode()
    except (TypeError, ValueError):
        return None
    cut = max((b for b in buckets if b <= len(raw)), default=len(raw))
    return raw[:cut]


def poll_phase(rid: str, interval_s: float) -> float:
    """Deterministic per-replica health-poll phase offset in
    ``[0, interval_s)``. An N-replica fleet polled on one shared timer
    fires N probes in the same instant every ``--healthIntervalS`` tick
    — a thundering herd the replicas all pay together. Hashing the
    replica id (stable blake2b, like the ring) spreads the probes
    across the interval identically on every router restart, so
    dashboards comparing probe timestamps across restarts stay
    comparable."""
    if interval_s <= 0:
        return 0.0
    return (_digest(f"poll#{rid}".encode()) % 9973) / 9973.0 * interval_s


class FleetRestartBudget:
    """The fleet tier's twin of the engine supervisor's restart budget
    (one :class:`~k8s_gpu_device_plugin_torch.serving.supervisor.RollingBudget`
    underneath):
    ``max_restarts`` replica-death recoveries per rolling ``window_s``.

    The unit is a replica DEATH, not a stream: one dead replica with N
    in-flight streams charges ONE budget event — every stream of that
    death resumes (or none does). ``charge(rep)`` keys on the replica's
    death epoch (bumped on revival), so concurrent streams dying from
    the same death share the charge, while a flapping replica burns one
    unit per death. ``max_restarts=0`` disables cross-replica resume —
    streams then end with the structured error frame, the same
    degrade-loudly stance as the supervisor's budget-0 mode."""

    def __init__(self, max_restarts: int = 3, window_s: float = 300.0):
        self._budget = RollingBudget(max_restarts, window_s)
        self.max_restarts = self._budget.max_events
        self.window_s = self._budget.window_s
        self._charged: set[tuple[str, int]] = set()
        self.charged_total = 0

    def charge(self, rep: Replica) -> bool:
        """True iff resuming streams of this replica death is within
        budget (charging it on first sight of the (replica, epoch))."""
        key = (rep.rid, rep.epoch)
        if key in self._charged:
            return True
        if not self._budget.allow():
            return False
        self._budget.record()
        # one live epoch per replica: drop the stale keys so the set
        # stays bounded by fleet size
        self._charged = {k for k in self._charged if k[0] != rep.rid}
        self._charged.add(key)
        self.charged_total += 1
        return True

    def stats(self) -> dict:
        return {
            "max_restarts": self.max_restarts,
            "window_s": self.window_s,
            "window_used": self._budget.used(),
            "charged_total": self.charged_total,
        }


class HashRing:
    """Consistent hashing with virtual nodes. ``candidates(key)`` walks
    the ring from the key's point and yields each distinct replica id
    once — index 0 is the key's HOME (where its cache lives); the rest
    are the failover/spill order, stable under membership changes in
    the usual consistent-hashing way (adding a replica moves ~1/N of
    the keyspace, not all of it)."""

    def __init__(self, ids: list[str], vnodes: int = 64):
        self._points: list[int] = []
        self._owner: dict[int, str] = {}
        self.ids = list(ids)
        for rid in ids:
            for v in range(vnodes):
                p = _digest(f"{rid}#{v}".encode())
                # a full 64-bit collision across ids is ~impossible;
                # last-writer-wins keeps construction deterministic
                self._owner[p] = rid
                self._points.append(p)
        self._points.sort()

    def candidates(self, key: bytes) -> list[str]:
        if not self._points:
            return []
        h = _digest(key)
        i = bisect.bisect_right(self._points, h)
        seen: list[str] = []
        for j in range(len(self._points)):
            rid = self._owner[self._points[(i + j) % len(self._points)]]
            if rid not in seen:
                seen.append(rid)
                if len(seen) == len(self.ids):
                    break
        return seen


class Replica:
    """One backend's registry entry (event-loop state, router-owned)."""

    __slots__ = (
        "rid", "url", "draining", "alive", "consecutive_failures",
        "health", "health_t", "inflight", "relayed", "cooldown_until",
        "reported_id", "spare", "epoch", "role",
    )

    def __init__(self, rid: str, url: str):
        self.rid = rid
        self.url = url.rstrip("/")
        self.draining = False
        self.alive = True          # optimistic until dead_after failures
        self.consecutive_failures = 0
        self.health: dict | None = None   # last /v1/health payload
        self.health_t = 0.0
        self.inflight = 0          # router-side: requests being relayed
        self.relayed = 0           # completed relays (any outcome)
        self.cooldown_until = 0.0  # honor a 429's Retry-After
        self.reported_id: str | None = None  # replica_id from /v1/health
        # warm-spare membership: a spare is registered and health-polled
        # but NOT on the ring and never routed — it waits to be promoted
        # when an active replica dies (a demoted ex-active that revives
        # becomes a spare: its ring slot is taken)
        self.spare = False
        # death-generation counter: bumps every time a dead replica
        # revives. The fleet restart budget charges ONE unit per
        # (replica, epoch) — one replica death with N in-flight streams
        # is one fleet event, not N
        self.epoch = 0
        # disaggregated prefill/decode specialization (--roles):
        # "prefill" replicas take long-prompt prefill legs, "decode"
        # replicas take short prompts and transferred continuations,
        # "any" (the default) serves both — an unroled fleet routes
        # byte-identically to before roles existed
        self.role = "any"

    def routable(self, now: float) -> bool:
        return (
            self.alive and not self.draining and not self.spare
            and now >= self.cooldown_until
        )


def _id_from_url(url: str) -> str:
    p = urlparse(url if "//" in url else f"http://{url}")
    host = p.hostname or url
    return f"{host}:{p.port}" if p.port else host


class FleetRegistry:
    """The replica set + liveness bookkeeping + the aggregate snapshot."""

    def __init__(self, replicas: list[Replica], dead_after: int = 3):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        ids = [r.rid for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        # the health poller and proxy-failure paths mutate the replica
        # map's entries; handlers read it ONLY through the registry's
        # own snapshot methods (ReplicaRouter.fleet_stats is the one
        # health accessor) — the same ownership discipline the engine-
        # side *_stats() snapshots follow, graftlint-pinned
        self._replicas: dict[str, Replica] = {  # owner: engine
            r.rid: r for r in replicas
        }
        self.dead_after = int(dead_after)

    @classmethod
    def from_spec(cls, spec: str, dead_after: int = 3) -> "FleetRegistry":
        """``--replicas`` value -> registry. Entries are
        ``id=http://host:port`` or bare URLs (id defaults to the URL's
        host:port — matching the replica's own ``--replicaId`` default
        when replicas are addressed by hostname; fleets addressed by
        IP/service DNS should name ids explicitly on both sides. The
        health-reported id lands in ``reported_id`` either way, so a
        mismatch shows on /fleet/health instead of hiding)."""
        reps = []
        for entry in (spec or "").split(","):
            entry = entry.strip()
            if not entry:
                continue
            if "=" in entry and not entry.split("=", 1)[0].startswith("http"):
                rid, url = entry.split("=", 1)
                rid = rid.strip()
            else:
                url, rid = entry, _id_from_url(entry)
            url = url.strip()
            if not rid or not url:
                raise ValueError(f"--replicas entry {entry!r}: "
                                 "expected [id=]http://host:port")
            if "://" not in url:
                # a scheme-less 'host:port' would raise InvalidURL on
                # every request — a silently permanently-dead replica
                url = f"http://{url}"
            reps.append(Replica(rid, url))
        return cls(reps, dead_after=dead_after)

    # --- roles (disaggregated prefill/decode) ----------------------------

    REPLICA_ROLES = ("prefill", "decode", "any")

    def assign_roles(self, spec: str) -> None:
        """Apply a ``--roles`` spec: whitespace/semicolon-separated
        ``role=id,id`` groups, e.g. ``prefill=r0 decode=r1,r2``.
        Unlisted replicas keep role ``"any"`` (they serve both sides).
        Unknown roles and unknown replica ids are refused — a typo must
        not silently leave a fleet colocated."""
        for group in (spec or "").replace(";", " ").split():
            role, _, ids = group.partition("=")
            role = role.strip()
            if role not in ("prefill", "decode"):
                raise ValueError(
                    f"--roles group {group!r}: unknown role {role!r} "
                    "(expected prefill=... or decode=...; unlisted "
                    "replicas default to 'any')"
                )
            for rid in (r.strip() for r in ids.split(",")):
                if not rid:
                    continue
                rep = self._replicas.get(rid)
                if rep is None:
                    raise ValueError(
                        f"--roles names unknown replica {rid!r}; "
                        f"registered: {self.ids()}"
                    )
                rep.role = role

    def roles_configured(self) -> bool:
        """True when any replica is specialized — the gate every
        disaggregation code path sits behind (an unroled fleet must
        behave byte-identically to a build without roles)."""
        return any(r.role != "any" for r in self._replicas.values())

    def role_capable(self, role: str) -> "list[Replica]":
        """Replicas that can serve ``role`` work: exact matches plus
        the unspecialized ``"any"`` generalists."""
        return [
            r for r in self._replicas.values()
            if r.role == role or r.role == "any"
        ]

    def removal_empties_role(self, rep: Replica) -> "str | None":
        """Would taking ``rep`` out of service leave a configured role
        unservable? Returns the actionable refusal message (for the
        drain/promote surfaces), or None when the swap is safe. A
        specialized replica is covered by its exact peers and by
        ``"any"`` generalists; an ``"any"`` replica may itself be the
        last cover for BOTH specialized roles."""
        if not self.roles_configured():
            return None
        covered = ("prefill", "decode") if rep.role == "any" \
            else (rep.role,)
        for role in covered:
            if not any(
                r is not rep and not r.spare and r.alive and not r.draining
                for r in self.role_capable(role)
            ):
                return (
                    f"replica {rep.rid!r} (role {rep.role!r}) is the "
                    f"last in-service cover for the {role!r} role; "
                    "undrain or add a replica with that role (or "
                    "'any') first"
                )
        return None

    def get(self, rid: str) -> Replica | None:
        return self._replicas.get(rid)

    def all(self) -> list[Replica]:
        return list(self._replicas.values())

    def ids(self) -> list[str]:
        return list(self._replicas)

    # --- warm spares ------------------------------------------------------

    def mark_spares(self, n: int) -> None:
        """Flag the LAST ``n`` registered replicas as warm spares
        (registered, health-polled, unrouted until promoted). The tail
        convention matches how an operator writes ``--replicas``: the
        serving set first, the standbys after."""
        reps = list(self._replicas.values())
        if not (0 <= n < len(reps)):
            raise ValueError(
                f"warm_spares must leave at least one active replica: "
                f"got {n} spares over {len(reps)} replicas"
            )
        for rep in reps[len(reps) - n:]:
            rep.spare = True

    def active(self) -> list[Replica]:
        """The ring membership: every non-spare replica (dead ones
        included — the ring is identity, liveness is routing)."""
        return [r for r in self._replicas.values() if not r.spare]

    def spares(self) -> list[Replica]:
        return [r for r in self._replicas.values() if r.spare]

    def promote_spare(self, dead: Replica) -> Replica | None:
        """Swap a dead active replica for a live warm spare: the spare
        joins the ring membership (the caller rebuilds the ring —
        affinity keys remap in the usual consistent-hashing way), the
        dead one becomes a spare so a later revival re-enters the pool
        as a standby instead of double-claiming a ring slot. Returns
        the promoted replica, or None when no live spare is idle.

        Role-aware (disaggregated fleets): the spare must be able to
        cover the dead replica's role — its exact role or ``"any"`` —
        and an ``"any"`` spare ADOPTS the dead replica's specialization
        so the swap never leaves a role empty; a spare specialized the
        other way is skipped (refusing the role-emptying swap)."""
        spare = next(
            (r for r in self.spares()
             if r.alive and not r.draining
             and r.role in ("any", dead.role)),
            None,
        )
        if spare is None:
            return None
        if spare.role == "any" and dead.role != "any":
            spare.role = dead.role
        spare.spare = False
        dead.spare = True
        return spare

    # --- liveness (fed by the health poller AND proxy failures) ---------

    def note_success(self, rep: Replica, health: dict | None = None) -> None:
        if not rep.alive or rep.consecutive_failures:
            # recovery from ANY observed failure — full death or a flap
            # that never reached dead_after — closes that death epoch:
            # the next failure is a NEW fleet event for the restart
            # budget (streams dying from one crash see no success in
            # between, so they still share one charge)
            rep.epoch += 1
        rep.consecutive_failures = 0
        rep.alive = True
        if health is not None:
            rep.health = health
            rep.health_t = time.monotonic()
            rep.reported_id = health.get("replica_id", rep.reported_id)

    def note_failure(self, rep: Replica) -> None:
        rep.consecutive_failures += 1
        if rep.consecutive_failures >= self.dead_after:
            rep.alive = False

    # --- views -----------------------------------------------------------

    def any_draining(self) -> bool:
        return any(r.draining for r in self._replicas.values())

    def snapshot(self) -> dict:
        """The ``GET /fleet/health`` aggregate: per-replica state plus
        fleet-level tallies (plain copies; everything is loop-owned)."""
        now = time.monotonic()
        reps = {}
        for r in self._replicas.values():
            h = r.health or {}
            reps[r.rid] = {
                "url": r.url,
                "alive": r.alive,
                "spare": r.spare,
                "role": r.role,
                "draining": r.draining,
                "inflight": r.inflight,
                "relayed": r.relayed,
                "consecutive_failures": r.consecutive_failures,
                "cooldown_s": round(max(0.0, r.cooldown_until - now), 3),
                "reported_id": r.reported_id,
                "health_age_s": (
                    round(now - r.health_t, 3) if r.health_t else None
                ),
                # the balancing-relevant slice of the replica's own
                # health (queue depth, slot occupancy, kv pool pressure,
                # scheduler rejections) — dashboards get the digest
                # without a second scrape fan-out
                "queued": h.get("queued"),
                "active": h.get("active"),
                "prefilling": h.get("prefilling"),
                "uptime_s": h.get("uptime_s"),
                "kv": h.get("kv"),
                "sched_rejections": (h.get("sched") or {}).get("rejections"),
            }
        live = [r for r in self._replicas.values() if r.alive]
        # per-role membership + in-flight (disaggregated fleets): "any"
        # rolls up separately so dashboards can tell generalist slack
        # from specialized capacity; an unroled fleet reads all-"any"
        roles: dict[str, dict] = {}
        for r in self._replicas.values():
            agg = roles.setdefault(
                r.role, {"replicas": 0, "live": 0, "inflight": 0}
            )
            agg["replicas"] += 1
            agg["live"] += 1 if r.alive else 0
            agg["inflight"] += r.inflight
        return {
            "replicas": reps,
            "total": len(self._replicas),
            "live": len(live),
            "spares": len(self.spares()),
            "roles": roles,
            "draining": sum(
                1 for r in self._replicas.values() if r.draining
            ),
            "inflight": sum(r.inflight for r in self._replicas.values()),
        }
