"""``DeviceMetrics`` on the port's registry, against the reference's.

The same chip maps (equal hosts under ``none``) and the same scripted
usage readings go to the reference's gauges (on a ``prometheus_client``
registry of their own) and the port's; the samples must be equal step
by step (exact), with the stated differences: the ``gpu_plugin_`` prefix
for ``tpu_plugin_``, ``nvidia.com/gpu`` for ``google.com/tpu``, each
generation's own memory, and no ``tensorcore_utilization`` family (NVML
has no such counter). ``prometheus_client`` is used only to parse the
port's renderings and to hold the reference's gauges.
"""

from __future__ import annotations

import pytest
from prometheus_client import CollectorRegistry, generate_latest
from prometheus_client.parser import text_string_to_metric_families

from k8s_gpu_device_plugin_torch.device import chip as tchip
from k8s_gpu_device_plugin_torch.device.chip_map import new_chip_map as t_map
from k8s_gpu_device_plugin_torch.device.fake import FakeBackend as TFake
from k8s_gpu_device_plugin_torch.metrics.device_metrics import DeviceMetrics as TDM
from k8s_gpu_device_plugin_torch.metrics.exposition import Registry
from k8s_gpu_device_plugin_torch.metrics.runtime_metrics import Usage as TUsage
from k8s_gpu_device_plugin_torch.resource import discover_resources as t_discover
from k8s_gpu_device_plugin_tpu.device import chip as rchip
from k8s_gpu_device_plugin_tpu.device import topology as rtopo
from k8s_gpu_device_plugin_tpu.device.chip_map import new_chip_map as r_map
from k8s_gpu_device_plugin_tpu.device.fake import FakeBackend as RFake
from k8s_gpu_device_plugin_tpu.metrics.device_metrics import DeviceMetrics as RDM
from k8s_gpu_device_plugin_tpu.metrics.runtime_metrics import Usage as RUsage
from k8s_gpu_device_plugin_tpu.resource import discover_resources as r_discover

GIB = 1 << 30


class _Frames:
    def __init__(self, frames):
        self.frames = list(frames)

    def read(self):
        return self.frames.pop(0) if len(self.frames) > 1 else self.frames[0]


def _maps(n: int, replicas: int, health: dict):
    rb = RFake(rtopo.HostTopology(rtopo.GENERATIONS["v5e"], (n,),
                                  wraparound=(False,)))
    r = r_map(rb, r_discover("none"), "none", shared_replicas=replicas)
    t = t_map(TFake(f"h100-{n}"), t_discover("none"), "none",
              shared_replicas=replicas)
    for cm, mod in ((r, rchip), (t, tchip)):
        for chips in cm.values():
            for cid, c in list(chips.items()):
                if c.index in health:
                    chips[cid] = c.with_health(
                        {"u": mod.UNHEALTHY, "k": mod.UNKNOWN}[health[c.index]])
    return r, t


@pytest.mark.parametrize("n,replicas,health", [
    (1, 0, {}), (4, 0, {1: "u", 2: "k"}), (8, 3, {0: "k", 7: "u"})])
def test_inventory_matches_reference(n, replicas, health):
    r_map_, t_map_ = _maps(n, replicas, health)
    rreg, treg = CollectorRegistry(), Registry()
    rdm, tdm = RDM(registry=rreg), TDM(registry=treg)
    rdm.update_inventory(r_map_)
    tdm.update_inventory(t_map_)
    for state in ("healthy", "unknown", "unhealthy"):
        assert treg.get_sample_value(
            "gpu_plugin_chips", {"resource": "nvidia.com/gpu", "state": state}) \
            == rreg.get_sample_value(
            "tpu_plugin_chips", {"resource": "google.com/tpu", "state": state})
    for i in range(n):
        assert rreg.get_sample_value("tpu_plugin_chip_hbm_total_bytes",
                                     {"chip": str(i), "generation": "v5e"}) \
            == rtopo.GENERATIONS["v5e"].hbm_bytes
        assert treg.get_sample_value("gpu_plugin_chip_hbm_total_bytes",
                                     {"chip": str(i), "generation": "h100"}) \
            == 80 * GIB
    assert treg.get_sample_value("gpu_plugin_build_info", {"version": "0.1.0"}) == 1
    assert rreg.get_sample_value("tpu_plugin_build_info", {"version": "0.1.0"}) == 1


FRAMES = [
    {0: (5 * GIB, 50.0), 1: (GIB, 7.5)},
    {0: (6 * GIB, 60.0)},          # GPU 1's workload is gone: zeroed
    {},                            # every workload gone
    {1: (2 * GIB, 99.0)},
]


def test_usage_and_zeroing_match_reference():
    rreg, treg = CollectorRegistry(), Registry()
    rdm = RDM(_Frames([{i: RUsage(b, d, 12.5) for i, (b, d) in f.items()}
                       for f in FRAMES]), registry=rreg)
    tdm = TDM(_Frames([{i: TUsage(b, d) for i, (b, d) in f.items()}
                       for f in FRAMES]), registry=treg)
    for _ in FRAMES:
        rdm.update_usage()
        tdm.update_usage()
        for chip in ("0", "1"):
            for fam in ("chip_hbm_used_bytes", "chip_duty_cycle_percent"):
                assert treg.get_sample_value(f"gpu_plugin_{fam}", {"chip": chip}) \
                    == rreg.get_sample_value(f"tpu_plugin_{fam}", {"chip": chip})
    assert treg.get_sample_value("gpu_plugin_chip_hbm_used_bytes",
                                 {"chip": "0"}) == 0
    assert treg.get_sample_value("gpu_plugin_chip_hbm_used_bytes",
                                 {"chip": "1"}) == 2 * GIB


@pytest.mark.parametrize("source,guessed", [("pci", 0), ("name", 0), ("config", 0),
                                            ("fake", 0), ("unknown", 1)])
def test_generation_guessed(source, guessed):
    reg = Registry()
    TDM(registry=reg).set_generation_source("h100", source)
    assert reg.get_sample_value("gpu_plugin_generation_guessed",
                                {"generation": "h100", "source": source}) == guessed
    if source in ("pci", "config", "fake", "unknown"):
        rreg = CollectorRegistry()
        RDM(registry=rreg).set_generation_source("v5e", source)
        assert rreg.get_sample_value("tpu_plugin_generation_guessed",
                                     {"generation": "v5e", "source": source}) \
            == guessed


def test_rendering_families_and_formats():
    reg = Registry()
    dm = TDM(_Frames([{0: TUsage(3 * GIB, 42.0, (7,))}]), registry=reg)
    dm.update_inventory(t_map(TFake("h100-2"), t_discover("none"), "none"))
    dm.set_generation_source("h100", "pci")
    dm.update_usage()
    text = dm.render()
    families = {f.name: f for f in text_string_to_metric_families(text)}
    assert sorted(families) == sorted(
        f"gpu_plugin_{n}" for n in (
            "build_info", "chips", "chip_hbm_total_bytes", "chip_hbm_used_bytes",
            "chip_duty_cycle_percent", "generation_guessed"))
    rfams = {f.name.replace("tpu_plugin_", "")
             for f in text_string_to_metric_families(
                 generate_latest(_ref_registry()).decode())}
    assert rfams - {f.replace("gpu_plugin_", "") for f in families} == {
        "chip_tensorcore_utilization"}  # NVML has no such counter
    assert {s.labels["chip"] for s in families["gpu_plugin_chip_hbm_total_bytes"]
            .samples} == {"0", "1"}
    assert dm.render(openmetrics=True).rstrip().endswith("# EOF")
    assert text == reg.render()


def _ref_registry():
    reg = CollectorRegistry()
    dm = RDM(_Frames([{0: RUsage(GIB, 1.0, 1.0)}]), registry=reg)
    dm.update_inventory(r_map(RFake("v5e-4"), r_discover("none"), "none"))
    dm.set_generation_source("v5e", "pci")
    dm.update_usage()
    return reg


def test_mig_instances_add_up_per_gpu():
    mig = {0: ["3g.40gb", "3g.40gb"], 1: ["1g.10gb"] * 7}
    backend = TFake("h100-3", mig=mig)
    topo = backend.host_topology()
    for replicas in (0, 2):
        reg = Registry()
        dm = TDM(registry=reg)
        dm.update_inventory(t_map(backend, t_discover("mixed", topo,
                                                      "3g.40gb,1g.10gb"),
                                  "mixed", shared_replicas=replicas))
        total = {c: reg.get_sample_value("gpu_plugin_chip_hbm_total_bytes",
                                         {"chip": c, "generation": "h100"})
                 for c in ("0", "1", "2")}
        assert total == {"0": 80 * GIB, "1": 70 * GIB, "2": 80 * GIB}
        assert reg.get_sample_value(
            "gpu_plugin_chips", {"resource": "nvidia.com/mig-1g.10gb",
                                 "state": "healthy"}) == 7 * max(1, replicas)


def test_a_registry_is_required():
    with pytest.raises(TypeError):
        TDM()  # no process-global registry
