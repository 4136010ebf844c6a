"""``HealthAssessor`` against the reference's, step by step.

Each scenario is one of the reference's scripted reader-and-probe
sequences (``tests/test_health.py``): the same frames, clock and probe
go to the reference's assessor and the port's, and every step's verdicts
and ``last_reasons`` must be equal (exact). Then the port's own parts:
the idle probe's child and ``assessor_from_config``.
"""

from __future__ import annotations

import types

import pytest

from k8s_gpu_device_plugin_torch.device import health as thealth
from k8s_gpu_device_plugin_torch.metrics.device_metrics import NullUsageReader
from k8s_gpu_device_plugin_torch.metrics.runtime_metrics import NvmlUsageReader
from k8s_gpu_device_plugin_tpu.device import health as rhealth


class _Clock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class _FakeReader:
    """Scriptable read_status(): a list of (usages, status) frames."""

    def __init__(self, frames):
        self.frames = list(frames)

    def read_status(self):
        if len(self.frames) > 1:
            return self.frames.pop(0)
        return self.frames[0]


class _ReadOnly:
    """A reader with only read(): the assessor infers the status."""

    def __init__(self, frames):
        self.frames = list(frames)

    def read(self):
        return self.frames.pop(0) if len(self.frames) > 1 else self.frames[0]


class _Raising:
    def read_status(self):
        raise OSError("NVML went away")


D = {0: object(), 1: object()}
D0 = {0: object()}
# (name, reader frames, assessor kwargs, probe verdicts over time or None,
#  steps: (clock, node health, assess kwargs))
SCENARIOS = [
    ("stale_with_reachable_endpoint",
     [(D, "data"), ({}, "silent")], {}, None,
     [(0.0, {0: True, 1: True}, {}), (10.0, {0: True, 1: True}, {}),
      (45.0, {0: True, 1: True}, {})]),
    ("clean_exit_is_not_a_wedge",
     [(D0, "data"), ({}, "absent")], {}, None,
     [(0.0, {0: True}, {}), (120.0, {0: True}, {})]),
    ("node_absence_and_per_chip_staleness",
     [(D, "data"), (D0, "data")], {}, None,
     [(0.0, {0: True, 1: True, 2: False}, {}),
      (45.0, {0: True, 1: True, 2: False}, {})]),
    ("idle_probe_failure_with_bounded_cadence",
     [({}, "absent")], {"probe_interval": 600.0},
     [(0.0, False), (700.0, True)],
     [(0.0, {0: True}, {}), (300.0, {0: True}, {}), (700.0, {0: True}, {})]),
    ("probe_never_fires_on_silent",
     [({}, "silent")], {"probe_interval": 1.0}, [(0.0, False)],
     [(0.0, {0: True}, {}), (5.0, {0: True}, {}), (10.0, {0: True}, {})]),
    ("no_scrape_never_probes",
     [({}, "absent")], {"probe_interval": 1.0}, [(0.0, False)],
     [(0.0, {0: True}, {"allow_probe": False, "scrape": False}),
      (5.0, {0: True}, {"allow_probe": False})]),
    ("readings_retire_a_probe_failure",
     [({}, "absent"), (D0, "data")], {"probe_interval": 600.0},
     [(0.0, False)],
     [(0.0, {0: True}, {}), (5.0, {0: True}, {})]),
    ("unhealthy_node_blocks_the_probe",
     [({}, "absent")], {"probe_interval": 1.0}, [(0.0, False)],
     [(0.0, {0: True, 1: False}, {}), (5.0, {0: True, 1: True}, {})]),
]


def _probe(schedule, clock, calls):
    if schedule is None:
        return None

    def probe():
        calls.append(clock.t)
        verdict = schedule[0][1]
        for t, v in schedule:
            if clock.t >= t:
                verdict = v
        return verdict

    return probe


@pytest.mark.parametrize("name,frames,kw,probe,steps", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_assessor_matches_reference_step_by_step(name, frames, kw, probe, steps):
    runs = {}
    for label, mod in (("ref", rhealth), ("port", thealth)):
        clock, calls = _Clock(), []
        a = mod.HealthAssessor(reader=_FakeReader(frames), stale_after=30.0,
                               probe=_probe(probe, clock, calls), clock=clock,
                               **kw)
        trace = []
        for t, node, assess_kw in steps:
            clock.t = t
            trace.append((a.assess(node, **assess_kw), dict(a.last_reasons)))
        runs[label] = (trace, calls)
    assert runs["port"] == runs["ref"]


@pytest.mark.parametrize("reader", ["read_only", "raising", "none"])
def test_assessor_reader_kinds_match_reference(reader):
    runs = {}
    for label, mod in (("ref", rhealth), ("port", thealth)):
        clock = _Clock()
        r = {"read_only": _ReadOnly([D0, {}]), "raising": _Raising(),
             "none": None}[reader]
        a = mod.HealthAssessor(reader=r, stale_after=30.0, clock=clock,
                               probe=lambda: False, probe_interval=1.0)
        trace = []
        for t in (0.0, 50.0, 100.0):
            clock.t = t
            trace.append((a.assess({0: True, 1: True}), dict(a.last_reasons)))
        runs[label] = trace
    assert runs["port"] == runs["ref"]


def test_idle_probe_child_and_its_timeout(monkeypatch):
    # the child runs one bf16 product on the card
    assert "bfloat16" in thealth.PROBE_CODE and "'cuda'" in thealth.PROBE_CODE
    monkeypatch.setattr(thealth, "PROBE_CODE", "pass")
    assert thealth.run_idle_probe(30.0) is True
    monkeypatch.setattr(thealth, "PROBE_CODE", "raise SystemExit(3)")
    assert thealth.run_idle_probe(30.0) is False
    monkeypatch.setattr(thealth, "PROBE_CODE", "import time; time.sleep(30)")
    assert thealth.run_idle_probe(0.5) is False


def test_assessor_from_config_follows_the_references_knobs(monkeypatch):
    made = []

    class _Reader(NvmlUsageReader):
        def __init__(self, **kw):
            made.append(kw)

    monkeypatch.setattr(
        "k8s_gpu_device_plugin_torch.metrics.runtime_metrics.NvmlUsageReader",
        _Reader)
    cfg = types.SimpleNamespace(runtime_metrics_ports="off",
                                health_idle_probe="off")
    assert thealth.assessor_from_config(cfg) is None
    cfg.health_idle_probe = "on"  # no readings: no idleness signal, no probe
    assert thealth.assessor_from_config(cfg) is None
    cfg = types.SimpleNamespace(runtime_metrics_ports="", health_idle_probe="on",
                                health_idle_probe_timeout=5.0,
                                health_stale_after=12.0,
                                health_idle_probe_interval=60.0,
                                runtime_metrics_cache_ttl=3.0)
    a = thealth.assessor_from_config(cfg)
    assert a is not None and a._stale_after == 12.0 and a._probe_interval == 60.0
    assert a._probe is not None and made == [
        {"nvml": None, "indices": None, "cache_ttl_seconds": 3.0}]
    # a shared null reader: no readings, so no probe either
    assert thealth.assessor_from_config(cfg, reader=NullUsageReader()) is None
