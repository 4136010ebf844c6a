"""``serving/fleet.py``: the router's state, held to the reference's
``k8s_gpu_device_plugin_tpu/serving/fleet.py`` on the same inputs.

Inputs are drawn with numpy from seeds: token prompts over bucket
ladders, text and chat structures for ``affinity_key``; replica ids and
keys for ``HashRing.candidates``; ``Retry-After`` values (delta-seconds,
RFC 9110 HTTP-dates ahead and behind, junk) for ``parse_retry_after``;
``poll_phase``; ``FleetRegistry.from_spec``, ``assign_roles``,
``mark_spares``, ``removal_empties_role`` and ``promote_spare`` with
their errors and messages; liveness sequences through
``note_success``/``note_failure`` and the ``snapshot``; and the
``FleetRestartBudget``'s answers over a sequence of charges. The port's
answer must equal the reference's. Also: the router imports no torch
at module import, and its ``MODEL_ID`` is the OpenAI façade's.
"""

import datetime
import email.utils
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from k8s_gpu_device_plugin_torch.serving import fleet as tfleet
from k8s_gpu_device_plugin_tpu.serving import fleet as jfleet

ROOT = Path(__file__).resolve().parent.parent
LADDERS = [(8, 16, 32), (32, 64, 128, 256, 512, 1024), (), (5,)]


def _outcome(fn, *args, **kw):
    """(result, None) or (None, (exception type name, message))."""
    try:
        return fn(*args, **kw), None
    except Exception as e:  # noqa: BLE001 - compared, not handled
        return None, (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(4))
def test_affinity_key_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    buckets = LADDERS[seed]
    sources = [None, "", [], [True, 1], "x" * int(rng.integers(1, 80)),
               {"b": 1, "a": [1, 2]}, [{"role": "user", "content": "hi"}],
               object()]
    for _ in range(30):
        n = int(rng.integers(1, 1100))
        sources.append(rng.integers(0, 128000, n).tolist())
        sources.append("".join(chr(c) for c in rng.integers(32, 0x2600, n)))
    for src in sources:
        assert tfleet.affinity_key(src, buckets) == \
            jfleet.affinity_key(src, buckets)


def test_hash_ring_candidates_match_the_reference():
    rng = np.random.default_rng(11)
    for n in (1, 2, 3, 5):
        ids = [f"r{i}" for i in range(n)] + ["127.0.0.1:8001"][:n % 2]
        t, j = tfleet.HashRing(ids), jfleet.HashRing(ids)
        for _ in range(100):
            key = rng.bytes(int(rng.integers(0, 64)))
            assert t.candidates(key) == j.candidates(key)
    assert tfleet.HashRing([]).candidates(b"x") == []


def _http_date(dt):
    return email.utils.format_datetime(dt, usegmt=True)


def test_parse_retry_after_matches_the_reference():
    now = datetime.datetime.now(datetime.timezone.utc)
    values = [None, "", "  ", "30", "0", "2.5", "-5", "999999999", "NaN",
              "inf", "-inf", "soon", "Tue, 99 Foo 2026", 7, 1.5,
              _http_date(now - datetime.timedelta(seconds=600)),
              # a zone-less RFC 5322 date, read as UTC
              (now - datetime.timedelta(seconds=30)).strftime(
                  "%a, %d %b %Y %H:%M:%S")]
    for raw in values:
        for kw in ({}, {"default": 3.0}, {"max_s": 10.0}):
            assert tfleet.parse_retry_after(raw, **kw) == \
                jfleet.parse_retry_after(raw, **kw), (raw, kw)
    # a date ahead: both read the same delay within the clock's tick
    ahead = _http_date(now + datetime.timedelta(seconds=45))
    t, j = tfleet.parse_retry_after(ahead), jfleet.parse_retry_after(ahead)
    assert 40.0 <= t <= 46.0 and abs(t - j) < 1.0


def test_poll_phase_matches_the_reference():
    for i in range(64):
        for interval in (0.0, -1.0, 0.05, 1.0, 7.5):
            rid = f"replica-{i}"
            assert tfleet.poll_phase(rid, interval) == \
                jfleet.poll_phase(rid, interval)


SPECS = ["r0=http://127.0.0.1:8001, http://127.0.0.1:8002",
         "a=http://h:1,b=http://h:2,c=h:3", "", ",", "x=http://h:1,x=h:2",
         "=http://h:1", "http://host-only", "a=http://h:1"]
ROLES = ["prefill=a decode=b", "prefill=a;decode=b,c", "prefill=zz",
         "gpu=a", "decode=a", "prefill=a,b,c", "", "prefill=a decode=c"]


def _registry_view(reg):
    return [(r.rid, r.url, r.role, r.spare) for r in reg.all()]


def test_registry_spec_roles_and_spares_match_the_reference():
    for spec in SPECS:
        t, te = _outcome(tfleet.FleetRegistry.from_spec, spec)
        j, je = _outcome(jfleet.FleetRegistry.from_spec, spec)
        assert te == je, spec
        if te is None:
            assert _registry_view(t) == _registry_view(j)
    base = "a=http://h:1,b=http://h:2,c=http://h:3"
    for roles in ROLES:
        for spares in (0, 1, 2, 3):
            t = tfleet.FleetRegistry.from_spec(base)
            j = jfleet.FleetRegistry.from_spec(base)
            assert _outcome(t.assign_roles, roles)[1] == \
                _outcome(j.assign_roles, roles)[1]
            assert _outcome(t.mark_spares, spares)[1] == \
                _outcome(j.mark_spares, spares)[1]
            assert _registry_view(t) == _registry_view(j)
            assert t.roles_configured() == j.roles_configured()
            for role in ("prefill", "decode", "any"):
                assert [r.rid for r in t.role_capable(role)] == \
                    [r.rid for r in j.role_capable(role)]
            for rid in ("a", "b", "c"):
                assert t.removal_empties_role(t.get(rid)) == \
                    j.removal_empties_role(j.get(rid))
            # a death and a promotion
            promoted = []
            for reg in (t, j):
                victim = reg.active()[0]
                victim.alive = False
                spare = reg.promote_spare(victim)
                promoted.append(None if spare is None else spare.rid)
            assert promoted[0] == promoted[1]
            assert _registry_view(t) == _registry_view(j)


def _snap(reg):
    snap = reg.snapshot()
    for rep in snap["replicas"].values():
        rep.pop("health_age_s")
        rep.pop("cooldown_s")
    return snap


def test_liveness_ledger_and_snapshot_match_the_reference():
    rng = np.random.default_rng(5)
    spec = "a=http://h:1,b=http://h:2"
    t = tfleet.FleetRegistry.from_spec(spec, dead_after=3)
    j = jfleet.FleetRegistry.from_spec(spec, dead_after=3)
    for step in range(200):
        rid = "ab"[int(rng.integers(0, 2))]
        ok = bool(rng.integers(0, 2))
        health = ({"replica_id": rid, "queued": step, "active": 1,
                   "uptime_s": float(step), "kv": {"pages": step},
                   "sched": {"rejections": 2}} if rng.integers(0, 2)
                  else None)
        for reg in (t, j):
            rep = reg.get(rid)
            if ok:
                reg.note_success(rep, health)
            else:
                reg.note_failure(rep)
            rep.inflight = step % 3
        assert [(r.alive, r.consecutive_failures, r.epoch, r.reported_id)
                for r in t.all()] == \
            [(r.alive, r.consecutive_failures, r.epoch, r.reported_id)
             for r in j.all()]
        assert _snap(t) == _snap(j)
        assert t.any_draining() == j.any_draining()


def test_fleet_restart_budget_matches_the_reference():
    rng = np.random.default_rng(9)
    for budget in (0, 1, 3):
        t = tfleet.FleetRestartBudget(budget, 60.0)
        j = jfleet.FleetRestartBudget(budget, 60.0)
        treps = [tfleet.Replica(f"r{i}", f"http://h:{i}") for i in range(3)]
        jreps = [jfleet.Replica(f"r{i}", f"http://h:{i}") for i in range(3)]
        for _ in range(40):
            i = int(rng.integers(0, 3))
            if rng.integers(0, 4) == 0:  # a revival: the next death is new
                treps[i].epoch += 1
                jreps[i].epoch += 1
            assert t.charge(treps[i]) == j.charge(jreps[i])
            assert t.stats() == j.stats()
    for bad in (dict(max_restarts=-1), dict(window_s=0)):
        assert _outcome(tfleet.FleetRestartBudget, **bad)[1] == \
            _outcome(jfleet.FleetRestartBudget, **bad)[1]


def test_router_module_imports_no_torch_and_agrees_on_model_id():
    code = ("import sys\n"
            "import k8s_gpu_device_plugin_torch.serving.router\n"
            "import k8s_gpu_device_plugin_torch.serving.async_http\n"
            "import k8s_gpu_device_plugin_torch.serving.fleet\n"
            "import k8s_gpu_device_plugin_torch.obs.fleet_obs\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'aiohttp', 'jax', 'prometheus_client')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    from k8s_gpu_device_plugin_torch.serving import openai_api, router

    assert router.MODEL_ID == openai_api.MODEL_ID


def test_router_folds_listed_adapters_only_as_the_reference():
    """``--adapterNames``: both surfaces extract the adapter; LISTED
    names prefix-fold the affinity key, counted on ``router_stats``;
    unlisted and base requests keep the key as it was. The port's router
    answers each case as the reference's does."""
    from k8s_gpu_device_plugin_torch.serving.router import ReplicaRouter
    from k8s_gpu_device_plugin_tpu.serving.router import (
        ReplicaRouter as JReplicaRouter,
    )

    buckets = (32, 64)
    t = ReplicaRouter(tfleet.FleetRegistry.from_spec("http://a:1,http://b:2"),
                      adapter_names=("fr", "de"), prompt_buckets=buckets)
    j = JReplicaRouter(jfleet.FleetRegistry.from_spec("http://a:1,http://b:2"),
                       adapter_names=("fr", "de"), prompt_buckets=buckets)
    bk = tfleet.affinity_key([1] * 40, buckets)
    cases = [("/v1/generate", {"prompt": [1] * 40, "adapter": "fr"}, bk),
             ("/v1/chat/completions", {"model": "de", "messages": []}, bk),
             ("/v1/completions", {"model": "tpu-serving"}, bk),
             ("/v1/generate", {"adapter": "fr"}, None),
             ("/v1/generate", {"prompt": [1] * 40, "adapter": "xx"}, bk),
             ("/v1/generate", {"prompt": [1] * 40}, bk),
             ("/v1/embeddings", {"model": "fr"}, None),
             ("/v1/generate", ["not", "a", "dict"], bk)]
    for path, body, key in cases:
        assert t._fold_adapter(path, body, key) == \
            j._fold_adapter(path, body, key), (path, body)
        assert t._affinity_source(path, body) == \
            j._affinity_source(path, body)
        assert t._resumable_body(path, body) == j._resumable_body(path, body)
    assert t.router_stats()["adapter_requests"] == \
        j.router_stats()["adapter_requests"] == {"fr": 2, "de": 1}
    assert t._fold_adapter("/v1/generate", {"prompt": [1] * 40,
                                            "adapter": "fr"}, bk) \
        == b"a:fr\x00" + bk
    bare = ReplicaRouter(tfleet.FleetRegistry.from_spec("http://a:1"),
                         prompt_buckets=buckets)
    assert bare._fold_adapter(
        "/v1/generate", {"prompt": [1] * 40, "adapter": "fr"}, bk) == bk
    assert bare.router_stats()["adapter_requests"] == {}


@pytest.mark.parametrize("seed", range(3))
def test_resumable_bodies_and_the_journal_match_the_reference(seed):
    """Which bodies carry a recovery journal, and the resume body a
    journal builds from the frames it saw, as the reference's."""
    from k8s_gpu_device_plugin_torch.serving import router as trouter
    from k8s_gpu_device_plugin_tpu.serving import router as jrouter

    rng = np.random.default_rng(seed)
    bodies = [{"prompt": rng.integers(0, 99, int(rng.integers(1, 9)))
               .tolist(), "stream": True, "max_new": 8},
              {"prompt": "text", "stream": True},
              {"prompt": [1, 2], "stream": False},
              {"prompt": [1, True], "stream": True},
              {"prompt": [1, 2], "stream": True, "n": 2},
              {"prompt": [1, 2], "stream": True, "n": "x"},
              {"prompt": [1, 2], "stream": True, "resume_out": [3],
               "resume_logprobs": [-0.5]},
              {"prompt": [1, 2], "stream": True, "resume_out": [3, 4]},
              {"prompt": [1, 2], "stream": True, "resume_out": ["x"]},
              {"prompt": [1, 2], "stream": True,
               "resume_logprobs": [True]}]
    frames = [{"token": int(t), "logprob": float(-rng.random())}
              for t in rng.integers(0, 99, 5)] + [{"done": True}]
    for body in bodies:
        ok = trouter.ReplicaRouter._resumable_body("/v1/generate", body)
        assert ok == jrouter.ReplicaRouter._resumable_body("/v1/generate",
                                                           body)
        if not ok:
            continue
        tj = trouter._StreamJournal(body, b"k")
        jj = jrouter._StreamJournal(body, b"k")
        for evt in frames[:int(rng.integers(0, 6))]:
            tj.observe(evt)
            jj.observe(evt)
        assert tj.resume_body() == jj.resume_body()
        assert (tj.tokens, tj.logps, tj.closed) == \
            (jj.tokens, jj.logps, jj.closed)
