"""SLO-aware request scheduling for the serving engine.

Port of ``k8s_gpu_device_plugin_tpu/serving/scheduler.py``: the same
policies, ledgers, orderings, victims, Retry-After hints and
``sched_stats`` for the same sequence of calls, the ``sched_queue`` span
and the metrics hooks (``observe_queue_wait``, ``on_sched_rejected``,
``on_deadline_miss``, ``on_goodput``, ``on_preemption``) through the
batcher's ``metrics``.

This module decides WHICH work runs when there is more of it than the
card can hold. The batcher keeps owning the pending list
(``ContinuousBatcher.pending``) and the slot machinery; a ``Scheduler``
plugs in behind a narrow duck-typed seam (the models/ layer never
imports serving/):

- ``on_submit(req, cb)``     — admission-control gate (queue cap,
  token-bucket quota charge); may raise :class:`SchedulerOverloadError`,
  which the HTTP planes translate to 429 + Retry-After.
- ``plan(cb, now)``          — once per ``_admit`` pass: reorders
  ``cb.pending`` IN PLACE (the head is the next admission), returns
  ``(rejects, preempt_slot)`` — requests whose pool-pressure deferral
  outlived the budget, and at most one running slot to preempt for a
  higher class about to miss its deadline.
- ``on_admitted / on_retired / on_preempted`` — accounting: queue-wait,
  deadline misses and overruns, per-class goodput, WFQ virtual time.
- ``sched_stats()``          — snapshot for cross-thread readers
  (/v1/health), the same approximate-read contract as ``kv_stats``.

Two policies:

- :class:`Scheduler` (``fifo``, the default): arrival order, no
  reordering, no preemption — byte-for-byte the pre-scheduler admission
  (token/logprob streams are pinned bit-identical with the scheduler
  attached or absent). It still ACCOUNTS deadlines/goodput and enforces
  ``max_queue``/``defer_budget_ms`` so the fifo arm of an A/B reports
  the same SLO numbers the slo arm does.
- :class:`SloScheduler` (``slo``): strict priority classes (lower int =
  more urgent), weighted fair queuing across tenants within a class
  (virtual time charged per admitted token / tenant weight),
  earliest-deadline-first within a tenant-class, token-bucket quotas
  (an over-quota tenant's requests sort behind every in-quota class —
  demoted, not dropped), and pressure-triggered preemption: when the
  head of the queue carries a deadline it cannot meet by waiting for
  the earliest natural slot retirement, the longest-running strictly-
  lower-class decode is evicted (its pages free, it requeues, and the
  resume re-prefills only what the prefix cache cannot serve —
  ``ContinuousBatcher._preempt_slot`` owns the mechanics; streams are
  pinned bit-identical across a preempt/resume cycle).

Thread model: the policy ledgers are engine-thread state
(``# owner: engine``); the request thread touches only ``max_queue``
(immutable) via :meth:`check_capacity`'s atomic ``len()`` path;
/v1/health goes through the :meth:`sched_stats` snapshot. The one
exception is the ``rejections`` counter pair: sync queue-full raises
are only visible to the HTTP planes, so :meth:`count_sync_rejection`
writes it off-thread under ``_rej_lock``.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass

from k8s_gpu_device_plugin_torch.obs.trace import get_tracer


#: the serving edge's defaults (applied in InferenceEngine.submit — a
#: request that names nothing lands here)
DEFAULT_TENANT = "default"
DEFAULT_PRIORITY = 1
#: priority classes are small ints, lower = more urgent; the bound keeps
#: metric label cardinality sane
MAX_PRIORITY = 9


class SchedulerOverloadError(RuntimeError):
    """The server cannot take this request NOW (queue full, or its
    pool-pressure deferral outlived the budget) — a transient condition,
    distinct from the permanent ValueError validation family. The HTTP
    planes translate it to 429 with a Retry-After hint."""

    def __init__(self, message: str, reason: str, retry_after: int):
        super().__init__(message)
        self.reason = reason   # queue_full | defer_budget | adapter_quota
        self.retry_after = int(retry_after)


@dataclass(frozen=True)
class TenantQuota:
    """Token-bucket + WFQ parameters for one tenant: ``rate`` tokens/s
    refill, ``burst`` bucket capacity (tokens), ``weight`` the WFQ
    share. ``rate=0`` means unmetered (weight still applies)."""

    rate: float = 0.0
    burst: float = 0.0
    weight: float = 1.0


def parse_tenant_quotas(spec: str) -> dict[str, TenantQuota]:
    """``--tenantQuota`` value -> {tenant: TenantQuota}.

    Syntax: ``name=rate[:burst=B][:weight=W],...`` — rate in tokens/s
    (prompt + budgeted output tokens charged at submit, refunded if the
    request is cancelled or rejected before ever taking a slot); burst
    defaults to 4x rate; weight defaults to 1."""
    out: dict[str, TenantQuota] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(
                f"--tenantQuota entry {entry!r}: expected name=rate"
                "[:burst=B][:weight=W]"
            )
        name, rest = entry.split("=", 1)
        name = name.strip()
        if not name:
            raise ValueError(f"--tenantQuota entry {entry!r}: empty tenant")
        parts = rest.split(":")
        try:
            rate = float(parts[0])
        except ValueError:
            raise ValueError(
                f"--tenantQuota entry {entry!r}: rate must be a number"
            ) from None
        burst = weight = None
        for p in parts[1:]:
            if p.startswith("burst="):
                burst = float(p[len("burst="):])
            elif p.startswith("weight="):
                weight = float(p[len("weight="):])
            else:
                raise ValueError(
                    f"--tenantQuota entry {entry!r}: unknown option {p!r}"
                )
        if rate < 0 or (burst is not None and burst < 0):
            raise ValueError(
                f"--tenantQuota entry {entry!r}: rate/burst must be >= 0"
            )
        if weight is not None and weight <= 0:
            raise ValueError(
                f"--tenantQuota entry {entry!r}: weight must be > 0"
            )
        out[name] = TenantQuota(
            rate=rate,
            burst=burst if burst is not None else 4.0 * rate,
            weight=weight if weight is not None else 1.0,
        )
    return out


def parse_adapter_quotas(spec: str) -> dict[str, TenantQuota]:
    """``--adapterQuota`` value -> {adapter name: TenantQuota}.

    Syntax: ``name=rate[:burst=B],...`` — rate in tokens/s charged per
    request (prompt + budgeted output, the same cost model as tenant
    quotas), burst defaults to 4x rate. Unlike tenant quotas these are
    HARD limits enforced at submit under every policy (fifo included):
    an adapter is a model variant, not a payer — there is no fairness
    ledger to demote against, so over-quota is a 429, not a demotion.
    Weight is not accepted: adapters never join the WFQ ordering."""
    out: dict[str, TenantQuota] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(
                f"--adapterQuota entry {entry!r}: expected "
                "name=rate[:burst=B]"
            )
        name, rest = entry.split("=", 1)
        name = name.strip()
        if not name:
            raise ValueError(
                f"--adapterQuota entry {entry!r}: empty adapter name"
            )
        parts = rest.split(":")
        try:
            rate = float(parts[0])
        except ValueError:
            raise ValueError(
                f"--adapterQuota entry {entry!r}: rate must be a number"
            ) from None
        burst = None
        for p in parts[1:]:
            if p.startswith("burst="):
                burst = float(p[len("burst="):])
            else:
                raise ValueError(
                    f"--adapterQuota entry {entry!r}: unknown option {p!r}"
                )
        if rate <= 0 or (burst is not None and burst < 0):
            raise ValueError(
                f"--adapterQuota entry {entry!r}: rate must be > 0 and "
                "burst >= 0 (omit the entry to leave an adapter unmetered)"
            )
        out[name] = TenantQuota(
            rate=rate,
            burst=burst if burst is not None else 4.0 * rate,
        )
    return out


class _AdapterState:
    """Per-adapter token bucket: the hard-reject ledger. Slimmer than
    ``_TenantState`` on purpose — adapters carry no WFQ identity, no
    deadlines, no goodput; just a bucket and the submit/reject tally."""

    __slots__ = ("quota", "level", "last_refill", "submitted", "rejected")

    def __init__(self, quota: TenantQuota, now: float):
        self.quota = quota
        self.level = quota.burst        # bucket starts full
        self.last_refill = now
        self.submitted = 0
        self.rejected = 0

    def refill(self, now: float) -> None:
        self.level = min(
            self.quota.burst,
            self.level + (now - self.last_refill) * self.quota.rate,
        )
        self.last_refill = now


class _TenantState:
    """Per-tenant ledger: token bucket, WFQ virtual time, tallies."""

    __slots__ = (
        "quota", "level", "last_refill", "vtime", "active", "submitted",
        "admitted", "retired", "preempted", "rejected", "deadline_misses",
        "goodput_tokens",
    )

    def __init__(self, quota: TenantQuota, now: float):
        self.quota = quota
        self.level = quota.burst        # bucket starts full
        self.last_refill = now
        self.vtime = 0.0
        self.active = 0                 # requests submitted, not retired
        self.submitted = 0
        self.admitted = 0
        self.retired = 0
        self.preempted = 0
        self.rejected = 0
        self.deadline_misses = 0
        self.goodput_tokens = 0

    def refill(self, now: float) -> None:
        if self.quota.rate > 0:
            self.level = min(
                self.quota.burst,
                self.level + (now - self.last_refill) * self.quota.rate,
            )
        self.last_refill = now

    def over_quota(self) -> bool:
        return self.quota.rate > 0 and self.level < 0


class Scheduler:
    """The ``fifo`` policy and the base of every other: arrival-order
    admission (``plan`` never reorders), no preemption — bit-identical
    to the pre-scheduler batcher — plus the accounting and overload
    valves every policy shares (queue cap, deferral budget, deadline /
    goodput / queue-wait bookkeeping).

    All mutable state is engine-thread-owned; cross-thread readers use
    :meth:`sched_stats` (snapshot) or :meth:`check_capacity` (atomic
    ``len()`` counts computed by the caller).
    """

    policy = "fifo"

    def __init__(
        self,
        max_queue: int = 0,
        defer_budget_ms: int = 0,
        quotas: "dict[str, TenantQuota] | None" = None,
        adapter_quotas: "dict[str, TenantQuota] | None" = None,
    ):
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        if defer_budget_ms < 0:
            raise ValueError(
                f"defer_budget_ms must be >= 0, got {defer_budget_ms}"
            )
        self.max_queue = int(max_queue)          # immutable after init
        self.defer_budget_s = defer_budget_ms / 1000.0  # immutable
        self.quotas = dict(quotas or {})         # immutable after init
        # hard per-adapter rate limits (parse_adapter_quotas); enforced
        # under EVERY policy — an adapter quota is capacity protection,
        # not fairness, so fifo enforces it too
        self.adapter_quotas = dict(adapter_quotas or {})  # immutable
        self._adapters: dict[str, _AdapterState] = {}  # owner: engine
        # rid -> (adapter name, cost) charged but not yet admitted
        # (refunded if the request dies while still queued)
        self._adapter_queued_cost: dict[int, tuple] = {}  # owner: engine
        self._tenants: dict[str, _TenantState] = {}  # owner: engine
        # rid -> quota tokens charged but not yet admitted (refunded if
        # the request dies while still queued)
        self._queued_cost: dict[int, float] = {}  # owner: engine
        # rid -> perf_counter of its FIRST pool-pressure deferral (the
        # defer-budget clock); cleared on admission/retirement
        self._defer_t0: dict[int, float] = {}  # owner: engine
        # EWMA of the inter-plan interval while busy (~ one decode step):
        # the wait estimator and the Retry-After hint
        self._ewma_step_s = 0.0  # owner: engine
        self._last_plan_t = 0.0  # owner: engine
        self._preempted_for: dict[int, int] = {}  # rid -> count; owner: engine
        self.preemptions = 0      # owner: engine
        # the ONE piece of mutable state written off the engine thread:
        # sync queue-full rejections are counted by the HTTP planes
        # (the raise happens on the request thread, so only they see
        # it), and dict-int += is not atomic — a lock keeps concurrent
        # 429 bursts from losing increments. defer_budget increments
        # ride the engine thread but share the dict, so they lock too.
        self._rej_lock = threading.Lock()
        self.rejections = {
            "queue_full": 0, "defer_budget": 0, "adapter_quota": 0,
        }
        self._tracer = get_tracer()

    # --- shared helpers ---------------------------------------------------

    def _tenant(self, name: str, now: float) -> _TenantState:
        ts = self._tenants.get(name)
        if ts is None:
            ts = self._tenants[name] = _TenantState(
                self.quotas.get(name, TenantQuota()), now
            )
        return ts

    def _refloor_vtime(self, ts: _TenantState) -> None:
        """A tenant whose backlog just (re)started — no live requests —
        must not replay virtual time banked while idle: that would let
        a returning tenant monopolize admission until the gap burned
        off. Standard WFQ: rejoin at the system virtual time (the
        minimum over tenants with live work)."""
        if ts.active:
            return
        floor = min(
            (t.vtime for t in self._tenants.values()
             if t is not ts and t.active > 0),
            default=None,
        )
        if floor is not None:
            ts.vtime = max(ts.vtime, floor)

    @staticmethod
    def request_cost(req) -> float:
        """Quota/WFQ charge for one request: the work it may occupy the
        chip with (prompt prefill + budgeted output)."""
        return float(len(req.prompt) + req.max_new)

    def retry_after_s(self) -> int:
        """Retry-After hint for overload responses: one average request
        drain if the step EWMA has data, else 1s."""
        if self._ewma_step_s > 0:
            return max(1, min(30, int(math.ceil(self._ewma_step_s * 64))))
        return 1

    # --- request-thread side ---------------------------------------------

    def check_capacity(self, queued_now: int) -> None:
        """Queue-cap gate for the REQUEST thread (the serving engine's
        submit handler): the caller computes ``queued_now`` from atomic
        ``len()`` reads; this method touches no engine-owned state."""
        if self.max_queue and queued_now >= self.max_queue:
            raise SchedulerOverloadError(
                f"request queue is full ({queued_now} waiting, cap "
                f"{self.max_queue}); retry later",
                reason="queue_full", retry_after=self.retry_after_s(),
            )

    # --- engine-thread seam (called by ContinuousBatcher) -----------------

    def _charge_adapter(self, req, cb, now: float) -> None:
        """Hard per-adapter token-bucket gate: raises 429 when the
        request's adapter is quota'd and its bucket cannot cover the
        cost. Runs BEFORE the tenant charge so a rejected request never
        touches the tenant ledger (nothing to refund)."""
        if not self.adapter_quotas or getattr(req, "adapter", -1) < 0:
            return
        names = getattr(cb, "adapter_names", ())
        name = names[req.adapter] if req.adapter < len(names) else ""
        quota = self.adapter_quotas.get(name) if name else None
        if quota is None:
            return
        st = self._adapters.get(name)
        if st is None:
            st = self._adapters[name] = _AdapterState(quota, now)
        st.refill(now)
        st.submitted += 1
        cost = self.request_cost(req)
        if st.level < cost:
            st.rejected += 1
            with self._rej_lock:
                self.rejections["adapter_quota"] += 1
            if cb.metrics is not None:
                cb.metrics.on_sched_rejected("adapter_quota")
            raise SchedulerOverloadError(
                f"adapter {name!r} is over its request-rate quota "
                f"({quota.rate:g} tokens/s); retry later",
                reason="adapter_quota", retry_after=self.retry_after_s(),
            )
        st.level -= cost
        self._adapter_queued_cost[req.rid] = (name, cost)

    def on_submit(self, req, cb) -> None:
        """Admission control + quota charge at enqueue time. Raising
        here leaves the batcher untouched (the request never queues)."""
        self.check_capacity(len(cb.pending))
        now = time.perf_counter()
        self._charge_adapter(req, cb, now)
        ts = self._tenant(req.tenant, now)
        ts.refill(now)
        self._refloor_vtime(ts)
        ts.submitted += 1
        ts.active += 1
        cost = self.request_cost(req)
        if ts.quota.rate > 0:
            # charge even into debt: over-quota demotes (slo) rather
            # than drops; the balance is refunded if the request is
            # cancelled or rejected before ever taking a slot
            ts.level -= cost
            self._queued_cost[req.rid] = cost

    def plan(self, cb, now: float) -> tuple[list, "int | None"]:
        """One admission pass: update the step EWMA, expire over-budget
        deferrals. FIFO never reorders and never preempts."""
        if self._last_plan_t:
            dt = now - self._last_plan_t
            # only count busy intervals (idle waits are not steps)
            if cb.running and 0 < dt < 1.0:
                self._ewma_step_s = (
                    0.9 * self._ewma_step_s + 0.1 * dt
                    if self._ewma_step_s else dt
                )
        self._last_plan_t = now
        return self._expired_deferrals(cb, now), None

    def _expired_deferrals(self, cb, now: float) -> list:
        """Pool-pressure deferrals older than the budget become
        rejections (the batcher retires them; the 429 surfaces through
        the request's stream info)."""
        if not self.defer_budget_s or not cb.pending:
            return []
        head = cb.pending[0]
        if not head.defer_counted or head.out:
            # a head with OUTPUT is a preempted request awaiting resume:
            # its tokens are already streaming to a client, so rejecting
            # it would 200 a silently truncated result — it keeps
            # waiting (pages free as slots retire; its class ordering
            # already puts it where the policy wants it)
            self._defer_t0.pop(head.rid, None)
            return []
        t0 = self._defer_t0.setdefault(head.rid, now)
        if now - t0 <= self.defer_budget_s:
            return []
        return [head]

    def on_admitted(self, req, cb, now: float) -> None:
        ts = self._tenant(req.tenant, now)
        ts.refill(now)
        self._queued_cost.pop(req.rid, None)  # charge becomes final
        self._adapter_queued_cost.pop(req.rid, None)  # ditto
        self._defer_t0.pop(req.rid, None)
        if req.preemptions or getattr(req, "restarts", 0):
            # a RESUMED request (preemption eviction, or an engine-crash
            # recovery resume — serving/supervisor.py): its first
            # admission already charged the full worst-case work and
            # observed the queue wait — re-charging the (now
            # output-inflated) prompt would demote the victims below
            # their fair share
            return
        ts.admitted += 1
        # WFQ virtual time advances by the admitted work / weight — the
        # fifo policy keeps the ledger too, so flipping --schedPolicy
        # changes ordering, not observability
        ts.vtime += self.request_cost(req) / ts.quota.weight
        if cb.metrics is not None:
            cb.metrics.observe_queue_wait(now - req.t_submit)
        if self._tracer.enabled and req.span is not None:
            # the scheduling span covers the queue wait (t0 backdated),
            # with the SLO identity the admit span does not carry
            self._tracer.span(
                "sched_queue", component="sched", parent=req.span,
                t0=req.t_submit, tenant=req.tenant, priority=req.priority,
                deadline_in_ms=(round((req.deadline - now) * 1000.0)
                                if req.deadline is not None else None),
            ).end()

    def on_retired(self, req, cb, reason: str, now: float) -> None:
        ts = self._tenant(req.tenant, now)
        ts.retired += 1
        ts.active = max(0, ts.active - 1)
        self._defer_t0.pop(req.rid, None)
        self._preempted_for.pop(req.rid, None)
        cost = self._queued_cost.pop(req.rid, None)
        if cost is not None:
            # died while still queued (cancel / defer-budget rejection):
            # the charged work never ran — give it back
            ts.refill(now)
            ts.level = min(ts.quota.burst, ts.level + cost)
        acharge = self._adapter_queued_cost.pop(req.rid, None)
        if acharge is not None:
            aname, acost = acharge
            ast = self._adapters.get(aname)
            if ast is not None:
                ast.refill(now)
                ast.level = min(ast.quota.burst, ast.level + acost)
        if reason == "rejected":
            ts.rejected += 1
            with self._rej_lock:
                self.rejections["defer_budget"] += 1
            if cb.metrics is not None:
                cb.metrics.on_sched_rejected("defer_budget")
            return
        if reason == "cancelled":
            return  # the client left: neither goodput nor a miss
        goodput = len(req.out)
        if req.deadline is not None and now > req.deadline:
            ts.deadline_misses += 1
            goodput = 0  # late tokens are not goodput
            if cb.metrics is not None:
                cb.metrics.on_deadline_miss(req.tenant, now - req.deadline)
        ts.goodput_tokens += goodput
        if cb.metrics is not None and goodput:
            cb.metrics.on_goodput(req.tenant, str(req.priority), goodput)

    def on_preempted(self, req, cb, now: float) -> None:
        ts = self._tenant(req.tenant, now)
        ts.preempted += 1
        self.preemptions += 1
        if cb.metrics is not None:
            cb.metrics.on_preemption()

    def count_sync_rejection(self, cb) -> None:
        """A submit-time queue-full raise never reaches the batcher;
        the HTTP plane reports it here so the rejection still lands in
        the stats and metrics. Runs OFF the engine thread — the one
        sanctioned write, under ``_rej_lock`` (the metric families lock
        themselves)."""
        with self._rej_lock:
            self.rejections["queue_full"] += 1
        if cb is not None and cb.metrics is not None:
            cb.metrics.on_sched_rejected("queue_full")

    # --- cross-thread snapshot --------------------------------------------

    def sched_stats(self) -> dict:
        """Queue + per-tenant view for /v1/health: plain numbers copied
        under the same approximate-read contract as ``kv_stats`` (the
        GIL keeps each read atomic; list() snapshots before iterating)."""
        tenants = {}
        for name, ts in list(self._tenants.items()):
            tenants[name] = {
                "submitted": ts.submitted,
                "admitted": ts.admitted,
                "retired": ts.retired,
                "preempted": ts.preempted,
                "rejected": ts.rejected,
                "deadline_misses": ts.deadline_misses,
                "goodput_tokens": ts.goodput_tokens,
                "quota_rate": ts.quota.rate,
                "quota_level": round(ts.level, 1),
                "weight": ts.quota.weight,
            }
        adapters = {}
        for name, ast in list(self._adapters.items()):
            adapters[name] = {
                "submitted": ast.submitted,
                "rejected": ast.rejected,
                "quota_rate": ast.quota.rate,
                "quota_level": round(ast.level, 1),
            }
        with self._rej_lock:
            rejections = dict(self.rejections)
        return {
            "policy": self.policy,
            "max_queue": self.max_queue,
            "defer_budget_ms": int(self.defer_budget_s * 1000),
            "preemptions": self.preemptions,
            "rejections": rejections,
            "step_ewma_ms": round(self._ewma_step_s * 1000.0, 3),
            "tenants": tenants,
            "adapters": adapters,
        }


class SloScheduler(Scheduler):
    """The ``slo`` policy: (over-quota, priority class, tenant WFQ
    virtual time, deadline, arrival) ordering plus pressure-triggered
    preemption. See the module docstring for the exact rules."""

    policy = "slo"

    def __init__(
        self,
        max_queue: int = 0,
        defer_budget_ms: int = 0,
        quotas: "dict[str, TenantQuota] | None" = None,
        preempt: bool = True,
        adapter_quotas: "dict[str, TenantQuota] | None" = None,
    ):
        super().__init__(max_queue=max_queue, defer_budget_ms=defer_budget_ms,
                         quotas=quotas, adapter_quotas=adapter_quotas)
        self.preempt_enabled = bool(preempt)  # immutable after init

    def plan(self, cb, now: float) -> tuple[list, "int | None"]:
        rejects, _ = super().plan(cb, now)
        if len(cb.pending) > 1:
            for ts in self._tenants.values():
                ts.refill(now)
            inf = float("inf")

            def key(req):
                ts = self._tenants.get(req.tenant)
                over = 1 if ts is not None and ts.over_quota() else 0
                vt = ts.vtime if ts is not None else 0.0
                return (
                    over, req.priority, vt,
                    req.deadline if req.deadline is not None else inf,
                    req.rid,
                )

            cb.pending.sort(key=key)
        return rejects, self._preempt_slot(cb, now, rejects)

    def _preempt_slot(self, cb, now: float, rejects) -> "int | None":
        """At most one victim per pass: the longest-running strictly-
        lower-class decode, evicted only when the queue head carries a
        deadline it cannot meet by waiting for the earliest natural
        retirement (estimated from remaining budgets x the step EWMA)."""
        if not self.preempt_enabled or not cb.pending or not cb.running:
            return None
        if not cb.chunk or not getattr(cb, "supports_preemption", False):
            return None  # resume rides the chunked-prefill scheduler
        head = cb.pending[0]
        if any(head is r for r in rejects) or head.deadline is None:
            return None
        ts = self._tenants.get(head.tenant)
        if ts is not None and ts.over_quota():
            return None  # an over-quota tenant never evicts anyone
        free = cb.n_slots - len(cb.running) - len(cb.prefilling)
        if free > 0 and not head.defer_counted:
            return None  # a slot is open and the pool can take it
        if self._preempted_for.get(head.rid, 0) >= cb.n_slots:
            return None  # this head already claimed every slot once
        remaining = min(
            (req.max_new - len(req.out) for req in cb.running.values()),
            default=0,
        )
        wait = remaining * self._ewma_step_s
        if head.deadline - now > wait:
            return None  # waiting still meets the deadline
        victims = [
            (slot, req) for slot, req in cb.running.items()
            if req.priority > head.priority
        ]
        if not victims:
            return None
        ledger = getattr(cb, "_slot_pages", None)
        if (head.defer_counted and ledger
                and getattr(cb, "window", 0) > 0):
            # The head waits on PAGES, not a slot, and out-of-window
            # recycling has broken the "longest decode = most KV"
            # proxy: a windowed row's footprint plateaus at O(window)
            # no matter how long it has run. Rank victims by the pages
            # their eviction actually returns (live ledger entries;
            # recycled slots are already 0), tie-broken toward the
            # least wasted decode work.
            def relief(sr):
                ids = ledger.get(sr[0], ())
                return (sum(1 for p in ids if p), -len(sr[1].out))

            slot = max(victims, key=relief)[0]
        else:
            slot = max(victims, key=lambda sr: len(sr[1].out))[0]
        self._preempted_for[head.rid] = \
            self._preempted_for.get(head.rid, 0) + 1
        return slot


def make_scheduler(
    policy: str,
    max_queue: int = 0,
    defer_budget_ms: int = 0,
    tenant_quota: str = "",
    preempt: bool = True,
    adapter_quota: str = "",
) -> Scheduler:
    """``--schedPolicy`` & friends -> a Scheduler (the server edge's one
    construction site; bench and tests may build policies directly)."""
    quotas = parse_tenant_quotas(tenant_quota)
    # adapter quotas are hard limits, not ordering — every policy
    # enforces them (unlike --tenantQuota, which fifo refuses)
    aquotas = parse_adapter_quotas(adapter_quota)
    if policy == "fifo":
        if quotas:
            raise ValueError(
                "--tenantQuota requires --schedPolicy slo (the fifo "
                "policy never consults quotas; silently accepting them "
                "would look like enforcement)"
            )
        return Scheduler(max_queue=max_queue,
                         defer_budget_ms=defer_budget_ms,
                         adapter_quotas=aquotas)
    if policy == "slo":
        return SloScheduler(max_queue=max_queue,
                            defer_budget_ms=defer_budget_ms,
                            quotas=quotas, preempt=preempt,
                            adapter_quotas=aquotas)
    raise ValueError(f"unknown scheduling policy {policy!r} "
                     "(expected 'fifo' or 'slo')")
