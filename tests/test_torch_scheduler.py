"""The port's scheduler against the reference's (``serving/scheduler.py``).

Both are driven by the same seeded sequence of operations over a stand-in
batcher (its ``pending`` list, ``running`` and ``prefilling`` maps, slot
count, chunk and page ledger) on one fake clock: submissions across
tenants, priorities and deadlines, planning passes, admissions,
pool-pressure deferrals, emissions, retirements, cancellations and
preemptions. After every operation the queue order, the rejects, the
named victim, ``retry_after_s`` and ``sched_stats`` must be equal. The
parsers and the page-relief victim ranking under a windowed pool are held
the same way.
"""

import copy
import time
import types

import numpy as np
import pytest

from k8s_gpu_device_plugin_torch.serving import scheduler as ts
from k8s_gpu_device_plugin_tpu.serving import scheduler as js

TENANTS = ("gold", "silver", "bronze")


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def _cb(n_slots: int = 3, window: int = 0):
    return types.SimpleNamespace(
        pending=[], running={}, prefilling={}, n_slots=n_slots, chunk=8,
        supports_preemption=True, _slot_pages={}, window=window,
        metrics=None, adapter_names=())


def _req(rid, rng, now):
    deadline = None if rng.random() < 0.4 else now + float(
        rng.uniform(0.0, 0.3))
    return types.SimpleNamespace(
        rid=rid, tenant=TENANTS[int(rng.integers(3))],
        priority=int(rng.integers(0, 4)), deadline=deadline,
        max_new=int(rng.integers(2, 12)),
        prompt=[1] * int(rng.integers(1, 30)), out=[], defer_counted=False,
        preemptions=0, restarts=0, t_submit=now, adapter=-1, span=None)


def _snapshot(sched, cb):
    return ([r.rid for r in cb.pending], sched.sched_stats(),
            sched.retry_after_s(), sched.preemptions)


def _drive(make, seed, monkeypatch, n_ops=400):
    """Run the same ops against the port's and the reference's scheduler
    built by ``make(module)``; assert equality after every op."""
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    rng = np.random.default_rng(seed)
    sides = []
    for mod in (ts, js):
        sides.append((mod, make(mod), _cb()))
    next_rid = 0
    counts = {"rejects": 0, "victims": 0, "overloads": 0}
    for _ in range(n_ops):
        op = rng.choice(["submit", "plan", "admit", "emit", "cancel",
                         "defer"], p=[0.3, 0.2, 0.15, 0.2, 0.05, 0.1])
        now = clock.t
        if op == "submit":
            base = _req(next_rid, rng, now)
            next_rid += 1
            raised = []
            for mod, sched, cb in sides:
                req = copy.deepcopy(base)
                try:
                    sched.on_submit(req, cb)
                except mod.SchedulerOverloadError as e:
                    raised.append((e.reason, e.retry_after, str(e)))
                    sched.count_sync_rejection(cb)
                    continue
                cb.pending.append(req)
            assert len(raised) in (0, 2) and (
                not raised or raised[0] == raised[1])
            counts["overloads"] += bool(raised)
        elif op == "plan":
            outs = []
            for mod, sched, cb in sides:
                rejects, victim = sched.plan(cb, now)
                outs.append(([r.rid for r in rejects], victim))
                for r in rejects:
                    cb.pending.remove(r)
                    sched.on_retired(r, cb, "rejected", now)
                if victim is not None:
                    req = cb.running.pop(victim)
                    req.preemptions += 1
                    sched.on_preempted(req, cb, now)
                    cb.pending.insert(0, req)
            assert outs[0] == outs[1]
            counts["rejects"] += len(outs[0][0])
            counts["victims"] += outs[0][1] is not None
        elif op == "admit":
            for mod, sched, cb in sides:
                free = [s for s in range(cb.n_slots) if s not in cb.running]
                if free and cb.pending:
                    req = cb.pending.pop(0)
                    req.defer_counted = False
                    cb.running[free[0]] = req
                    sched.on_admitted(req, cb, now)
        elif op == "defer":
            for _, _, cb in sides:
                if cb.pending:
                    cb.pending[0].defer_counted = True
        elif op == "emit":
            for mod, sched, cb in sides:
                for slot, req in list(cb.running.items()):
                    req.out.append(0)
                    if len(req.out) >= req.max_new:
                        del cb.running[slot]
                        sched.on_retired(req, cb, "budget", now)
        elif op == "cancel":
            for mod, sched, cb in sides:
                if cb.pending:
                    req = cb.pending.pop(len(cb.pending) // 2)
                    sched.on_retired(req, cb, "cancelled", now)
        clock.t += float(rng.uniform(0.001, 0.05))
        assert _snapshot(*sides[0][1:]) == _snapshot(*sides[1][1:])
    return counts


def test_fifo_equals_the_reference_op_for_op(monkeypatch):
    counts = _drive(lambda m: m.Scheduler(max_queue=6, defer_budget_ms=40),
                    seed=1, monkeypatch=monkeypatch)
    assert counts["overloads"] > 0 and counts["rejects"] > 0
    assert counts["victims"] == 0


@pytest.mark.parametrize("seed", [2, 3])
def test_slo_equals_the_reference_op_for_op(monkeypatch, seed):
    def make(m):
        return m.SloScheduler(
            max_queue=8, defer_budget_ms=30,
            quotas=m.parse_tenant_quotas("gold=300:weight=4,bronze=20"))

    counts = _drive(make, seed=seed, monkeypatch=monkeypatch)
    assert counts["victims"] > 0 and counts["overloads"] > 0


def test_page_relief_victim_under_a_windowed_pool():
    """The reference's windowed ranking (``scheduler.py:680-693``): a
    pool-pressured head evicts the victim whose eviction returns the most
    live pages; at window 0 the longest decode."""
    def req(rid, priority, out_n, deadline=None, defer=False):
        return types.SimpleNamespace(
            rid=rid, tenant="t", priority=priority, max_new=20,
            out=[0] * out_n, deadline=deadline, defer_counted=defer)

    picks = []
    for mod in (ts, js):
        head = types.SimpleNamespace(
            rid=9, tenant="t", priority=0, max_new=4, out=[],
            deadline=0.0, defer_counted=True)
        cb = _cb(n_slots=2, window=16)
        cb.pending = [head]
        cb.running = {0: req(1, 5, 10), 1: req(2, 5, 2)}
        cb._slot_pages = {0: [0, 0, 0, 7, 8], 1: [1, 2, 3, 4, 5, 6]}
        picks.append(mod.SloScheduler()._preempt_slot(cb, now=1.0,
                                                      rejects=[]))
        cb.window = 0
        picks.append(mod.SloScheduler()._preempt_slot(cb, now=1.0,
                                                      rejects=[]))
    assert picks == [1, 0, 1, 0]


@pytest.mark.parametrize("spec", [
    "gold=100", "gold=100:burst=50:weight=2,silver=0:weight=0.5",
    "gold", "=5", "gold=abc", "gold=1:bogus=2", "gold=-1", "gold=1:weight=0",
])
def test_tenant_quota_parser_equals_the_reference(spec):
    try:
        want = js.parse_tenant_quotas(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ts.parse_tenant_quotas(spec)
        assert str(got.value) == str(e)
        return
    got = ts.parse_tenant_quotas(spec)
    assert {k: (v.rate, v.burst, v.weight) for k, v in got.items()} == {
        k: (v.rate, v.burst, v.weight) for k, v in want.items()}


@pytest.mark.parametrize("args", [
    ("fifo",), ("slo",), ("fifo", 0, 0, "gold=5"), ("lifo",),
])
def test_make_scheduler_equals_the_reference(args):
    outs = []
    for mod in (ts, js):
        try:
            outs.append(type(mod.make_scheduler(*args)).__name__)
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]
    cap = ts.Scheduler(max_queue=2)
    cap.check_capacity(1)
    with pytest.raises(ts.SchedulerOverloadError) as e:
        cap.check_capacity(2)
    assert (e.value.reason, e.value.retry_after) == ("queue_full", 1)
