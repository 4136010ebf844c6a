"""``device/nvml.py`` and the NVML usage reader against a fake NVML.

The fake (``device/testing.py``) is compiled from C++ source once per
module with the host's C++ compiler and copied per test, so each test
loads a library of its own, with empty state. Every check is exact.
"""

from __future__ import annotations

import shutil

import pytest

from k8s_gpu_device_plugin_torch.device import nvml as tnvml
from k8s_gpu_device_plugin_torch.device.testing import FakeNvml, HostGpu, write_host
from k8s_gpu_device_plugin_torch.metrics import runtime_metrics as trm
from k8s_gpu_device_plugin_torch.metrics.device_metrics import NullUsageReader

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="needs a C++ compiler to build the fake NVML")

UUIDS = [f"GPU-{i:08x}-aaaa-bbbb-cccc-0123456789ab" for i in range(4)]
GIB = 1 << 30


@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory):
    return FakeNvml.build(tmp_path_factory.mktemp("fake_nvml")).path


@pytest.fixture
def fake(fake_lib, tmp_path):
    copy = tmp_path / "libnvidia-ml-fake.so"
    shutil.copy(fake_lib, copy)
    return FakeNvml(copy)


def _two_gpus(fake):
    fake.add_gpu(minor=3, uuid=UUIDS[0], bus_id="00000000:18:00.0",
                 pci_device_id=0x2330, numa=0)
    fake.add_gpu(minor=1, uuid=UUIDS[1])  # PCI and NUMA: Not Supported


def test_binding_reads_devices(fake):
    _two_gpus(fake)
    fake.set_usage(0, 3 * GIB, 57)
    with tnvml.Nvml(str(fake.path)) as nv:
        assert fake.inits() == 1 and nv.device_count() == 2
        h0, h1 = nv.handle_by_index(0), nv.handle_by_index(1)
        assert nv.uuid(h0) == UUIDS[0] and nv.uuid(h1) == UUIDS[1]
        assert nv.name(h0) == "NVIDIA H100 80GB HBM3"
        assert (nv.minor_number(h0), nv.minor_number(h1)) == (3, 1)
        assert nv.uuid(nv.handle_by_uuid(UUIDS[1])) == UUIDS[1]
        mem = nv.memory_info(h0)
        assert mem.total == 85520809984 and mem.used == 3 * GIB
        assert mem.reserved == 85520809984 // 160
        assert mem.free == mem.total - mem.reserved - mem.used
        assert nv.utilization(h0) == tnvml.Utilization(57, 19)
        assert nv.pci_device_id(h0) == 0x2330 and nv.pci_device_id(h1) is None
        assert nv.pci_bus_id(h0) == "00000000:18:00.0" and nv.pci_bus_id(h1) is None
        assert nv.numa_node(h0) == 0 and nv.numa_node(h1) is None
        assert nv.mig_mode(h0) == (0, 0)
        assert nv.compute_processes(h0) == []
    assert fake.shutdowns() == 1


def test_memory_falls_back_to_v1(fake):
    _two_gpus(fake)
    fake.set_memory_v2(False)
    fake.set_usage(0, GIB, 0)
    nv = tnvml.Nvml(str(fake.path))
    mem = nv.memory_info(nv.handle_by_index(0))
    # v1's used counts the driver's reservation
    assert mem.reserved is None and mem.used == GIB + 85520809984 // 160


@pytest.mark.parametrize("n", [1, 3, 8])
def test_compute_processes_grow_the_buffer(fake, n):
    _two_gpus(fake)
    fake.set_procs(1, [(100 + i, (i + 1) * GIB) for i in range(n)])
    nv = tnvml.Nvml(str(fake.path))
    got = nv.compute_processes(nv.handle_by_index(1))
    assert got == [tnvml.Process(100 + i, (i + 1) * GIB) for i in range(n)]


def test_errors_carry_nvml_error_string(fake, tmp_path):
    _two_gpus(fake)
    nv = tnvml.Nvml(str(fake.path))
    with pytest.raises(tnvml.NvmlError, match="Not Found") as e:
        nv.handle_by_uuid("GPU-nope")
    assert e.value.code == tnvml.NVML_ERROR_NOT_FOUND
    assert e.value.function == "nvmlDeviceGetHandleByUUID"
    fake.set_lost(0)
    with pytest.raises(tnvml.GpuLostError, match="GPU is lost") as e:
        nv.memory_info(nv.handle_by_index(0))
    assert e.value.code == tnvml.NVML_ERROR_GPU_IS_LOST
    assert nv.memory_info(nv.handle_by_index(1)).total  # the other answers
    with pytest.raises(tnvml.NvmlError, match="cannot load"):
        tnvml.Nvml(str(tmp_path / "missing.so"))


def test_init_failure_raises(fake):
    fake.set_init_error(9)
    with pytest.raises(tnvml.NvmlError, match="Driver Not Loaded"):
        tnvml.Nvml(str(fake.path))


def test_mig_devices(fake):
    _two_gpus(fake)
    fake.set_mig(0)
    fake.add_mig(0, "MIG-00000000-1111-2222-3333-444444444444", "3g.40gb", 1, 0,
                 40 * GIB)
    fake.add_mig(0, "MIG-00000001-1111-2222-3333-444444444444", "1g.10gb", 7, 0,
                 10 * GIB)
    nv = tnvml.Nvml(str(fake.path))
    h0 = nv.handle_by_index(0)
    assert nv.device_count() == 2 and nv.mig_mode(h0) == (1, 1)
    migs = nv.mig_devices(h0)
    assert [tnvml.mig_profile_of(nv.name(m)) for m in migs] == ["3g.40gb", "1g.10gb"]
    assert [(nv.gpu_instance_id(m), nv.compute_instance_id(m)) for m in migs] == \
        [(1, 0), (7, 0)]
    assert [nv.memory_info(m).total for m in migs] == [40 * GIB, 10 * GIB]
    assert nv.mig_devices(nv.handle_by_index(1)) == []
    with pytest.raises(ValueError):
        tnvml.mig_profile_of("NVIDIA H100 80GB HBM3")


def test_is_uuid():
    assert tnvml.is_uuid(UUIDS[0])
    assert tnvml.is_uuid("MIG-00000000-1111-2222-3333-444444444444")
    assert not tnvml.is_uuid("GPU-REDACTED") and not tnvml.is_uuid("")


# --- the usage reader ------------------------------------------------------


def test_reader_statuses(fake, monkeypatch):
    monkeypatch.setattr(trm, "this_process_holds_the_card", lambda: False)
    _two_gpus(fake)
    reader = trm.NvmlUsageReader(library=str(fake.path))
    assert reader.read_status() == ({}, "absent")
    # memory held, no process listed: cannot tell (a PID namespace)
    fake.set_usage(1, 2 * GIB, 0)
    assert reader.read_status() == ({1: trm.Usage(2 * GIB, 0.0, ())}, "silent")
    # a listed process: a workload
    fake.set_usage(0, 9 * GIB, 88)
    fake.set_procs(0, [(4242, 9 * GIB)])
    usages, status = reader.read_status()
    assert status == "data"
    assert usages == {0: trm.Usage(9 * GIB, 88.0, (4242,)),
                      1: trm.Usage(2 * GIB, 0.0, ())}
    assert reader.read() == usages
    # workload gone
    fake.set_usage(0, 0, 0)
    fake.set_usage(1, 0, 0)
    fake.set_procs(0, [])
    assert reader.read_status() == ({}, "absent")
    # this process holds the card but NVML lists nothing: cannot tell
    monkeypatch.setattr(trm, "this_process_holds_the_card", lambda: True)
    assert reader.read_status() == ({}, "silent")
    reader.close()
    assert fake.shutdowns() == 1


def test_reader_lost_gpu_and_v1_memory(fake, monkeypatch):
    monkeypatch.setattr(trm, "this_process_holds_the_card", lambda: False)
    _two_gpus(fake)
    fake.set_memory_v2(False)  # v1: used includes the reservation
    reader = trm.NvmlUsageReader(library=str(fake.path))
    assert reader.read_status() == ({}, "absent")
    fake.set_lost(1)
    assert reader.read_status() == ({}, "silent")


def test_reader_keys_by_the_enumerators_index_and_caches(fake, monkeypatch):
    monkeypatch.setattr(trm, "this_process_holds_the_card", lambda: False)
    _two_gpus(fake)
    fake.set_usage(1, GIB, 5)
    fake.set_procs(1, [(7, GIB)])
    nv = tnvml.Nvml(str(fake.path))
    reader = trm.NvmlUsageReader(nvml=nv, indices={1: 0, 0: 1},
                                 cache_ttl_seconds=60.0)
    assert list(reader.read()) == [0]
    fake.set_procs(1, [])
    fake.set_usage(1, 0, 0)
    assert list(reader.read()) == [0]  # cached
    fresh = trm.NvmlUsageReader(nvml=nv, indices={1: 0})
    assert fresh.read_status() == ({}, "absent")
    reader.close()
    assert fake.shutdowns() == 0  # the caller's session stays open
    only = trm.NvmlUsageReader(nvml=nv, indices={0: 5})
    fake.set_usage(1, GIB, 1)  # NVML's device 1 is not among the indices
    assert only.read_status() == ({}, "absent")


def test_usage_reader_from_config(fake, monkeypatch):
    import types

    cfg = types.SimpleNamespace(runtime_metrics_ports="off")
    assert isinstance(trm.usage_reader_from_config(cfg), NullUsageReader)
    _two_gpus(fake)
    nv = tnvml.Nvml(str(fake.path))
    backend = types.SimpleNamespace(nvml=nv, nvml_indices=lambda: {0: 0, 1: 1})
    cfg = types.SimpleNamespace(runtime_metrics_ports="8431",
                                runtime_metrics_cache_ttl=0.5)
    reader = trm.usage_reader_from_config(cfg, backend)
    assert isinstance(reader, trm.NvmlUsageReader)
    assert reader._nvml is nv and reader._ttl == 0.5


def test_gpu_is_lost_reads_unhealthy(fake, tmp_path, monkeypatch):
    """GPU_IS_LOST on a GPU whose node is fine: the native backend's
    health reads it unhealthy, the others stay healthy."""
    from k8s_gpu_device_plugin_torch.device import new_chip_map
    from k8s_gpu_device_plugin_torch.device.native import NativeBackend
    from k8s_gpu_device_plugin_torch.resource import discover_resources

    _two_gpus(fake)
    root = write_host(tmp_path / "root", [HostGpu("", 3, info=False),
                                          HostGpu("", 1, info=False)])
    monkeypatch.setenv("GPUENUM_ROOT", str(root))
    backend = NativeBackend(nvml_library=str(fake.path))
    specs = backend.enumerate_chips()
    assert [(s.uuid, s.paths) for s in specs] == [
        (UUIDS[0], ("/dev/nvidia3",)), (UUIDS[1], ("/dev/nvidia1",))]
    assert backend.check_health() == {0: True, 1: True}
    fake.set_lost(1)
    assert backend.check_health() == {0: True, 1: False}
    fake.set_lost(1, False)
    (root / "dev" / "nvidia3").unlink()  # the node is gone
    assert backend.check_health() == {0: False, 1: True}
    chip_map = new_chip_map(backend, discover_resources("none"), "none")
    assert chip_map["nvidia.com/gpu"].ids() == sorted(UUIDS[:2])
