"""The GPU enumerator (``native/gpuenum.cc``) and the native backend.

``gpuenum_test.cc`` and the library are built with the host's C++
compiler and read a synthetic ``$GPUENUM_ROOT`` tree of ``/dev``,
``/proc`` and ``/sys``: four H100s on two NUMA nodes, an NVIDIA device
whose PCI id the table does not know (a GUESSED warning), a non-NVIDIA
device the driver lists (skipped), a bare node and a ``mig-minors``
file. The native backend joins the tree to a fake NVML
(``device/testing.py``). Every check is exact.
"""

from __future__ import annotations

import logging
import shutil
import subprocess

import pytest

from k8s_gpu_device_plugin_torch.device import native
from k8s_gpu_device_plugin_torch.device import new_chip_map
from k8s_gpu_device_plugin_torch.device.factory import make_backend
from k8s_gpu_device_plugin_torch.device.testing import FakeNvml, HostGpu, write_host
from k8s_gpu_device_plugin_torch.device.topology import GENERATIONS
from k8s_gpu_device_plugin_torch.resource import discover_resources
from k8s_gpu_device_plugin_torch.utils import native_build
from k8s_gpu_device_plugin_torch.utils.log import get_logger

pytestmark = pytest.mark.skipif(native_build.find_cxx() is None,
                                reason="needs a C++ compiler ($CXX or g++)")

UUIDS = [f"GPU-{i:08x}-1111-2222-3333-444455556666" for i in range(8)]
# four H100s out of bus order on two NUMA nodes, one unknown PCI id, one
# device of another vendor
HOST = [
    HostGpu("0000:9b:00.0", 2, UUIDS[2], numa_node=1),
    HostGpu("0000:18:00.0", 0, UUIDS[0], numa_node=0),
    HostGpu("0000:bb:00.0", 3, UUIDS[3], numa_node=1),
    HostGpu("0000:2a:00.0", 1, UUIDS[1], numa_node=0),
    HostGpu("0000:db:00.0", 4, UUIDS[4], device=0x2331, numa_node=1,
            model="NVIDIA H100 PCIe"),
    HostGpu("0000:05:00.0", 7, UUIDS[7], vendor=0x1af4, device=0x1050),
]
MIG_MINORS = ("config 1\nmonitor 2\ngpu0/gi1/access 12\ngpu0/gi1/ci0/access 13\n"
              "gpu0/gi2/access 21\ngpu0/gi2/ci0/access 22\n")


@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory):
    return FakeNvml.build(tmp_path_factory.mktemp("fake_nvml")).path


@pytest.fixture
def fake(fake_lib, tmp_path):
    copy = tmp_path / "libnvidia-ml-fake.so"
    shutil.copy(fake_lib, copy)
    return FakeNvml(copy)


@pytest.fixture
def warnings():
    """The port logger's warnings, as {"msg", **fields}."""
    got = []

    class _Keep(logging.Handler):
        def emit(self, record):
            got.append({"msg": record.getMessage(),
                        **getattr(record, "fields", {})})

    logger = get_logger()
    handler = _Keep(logging.WARNING)
    logger.addHandler(handler)
    yield got
    logger.removeHandler(handler)


def test_cc_unit_test_passes(tmp_path):
    binary = tmp_path / "gpuenum_test"
    src = native_build.NATIVE_DIR
    subprocess.run([*native_build.find_cxx(), "-std=c++17", "-O2", "-Wall",
                    "-Wextra", "-Werror", "-o", str(binary),
                    str(src / "gpuenum_test.cc"), str(src / "gpuenum.cc")],
                   check=True, capture_output=True, timeout=120)
    proc = subprocess.run([str(binary)], capture_output=True, text=True,
                          timeout=60, env={"TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    assert "all checks passed" in proc.stdout


def test_library_reads_the_tree(tmp_path, monkeypatch):
    root = write_host(tmp_path, [*HOST, HostGpu("", 9, info=False)], MIG_MINORS)
    monkeypatch.setenv("GPUENUM_ROOT", str(root))
    lib = native.load_library()
    raw = native.enumerate_raw(lib)
    assert [(r.minor, r.numa_node, r.has_info, r.pci_device_id,
             r.generation.decode(), r.bus_id.decode(), r.uuid.decode(),
             r.path.decode()) for r in raw] == [
        (0, 0, 1, 0x2330, "h100", "0000:18:00.0", UUIDS[0], "/dev/nvidia0"),
        (1, 0, 1, 0x2330, "h100", "0000:2a:00.0", UUIDS[1], "/dev/nvidia1"),
        (2, 1, 1, 0x2330, "h100", "0000:9b:00.0", UUIDS[2], "/dev/nvidia2"),
        (3, 1, 1, 0x2330, "h100", "0000:bb:00.0", UUIDS[3], "/dev/nvidia3"),
        (4, 1, 1, 0x2331, "", "0000:db:00.0", UUIDS[4], "/dev/nvidia4"),
        (9, -1, 0, 0, "", "", "", "/dev/nvidia9")]
    assert all(r.index == i for i, r in enumerate(raw))
    assert native.mig_caps(lib) == {(0, 1, -1): 12, (0, 1, 0): 13,
                                    (0, 2, -1): 21, (0, 2, 0): 22}
    monkeypatch.setenv("GPUENUM_ROOT", str(tmp_path / "empty"))
    assert native.enumerate_raw(lib) == [] and native.mig_caps(lib) == {}


def test_pci_table_agrees_with_the_generation_table():
    lib = native.load_library()
    for name, gen in GENERATIONS.items():
        assert native.generation_of(lib, gen.pci_device_id) == name
    assert native.generation_of(lib, 0x2331) == ""


def test_native_backend_on_a_full_host(fake, tmp_path, monkeypatch, warnings):
    root = write_host(tmp_path / "root", [*HOST, HostGpu("", 9, info=False)],
                      MIG_MINORS)
    monkeypatch.setenv("GPUENUM_ROOT", str(root))
    for i in range(5):  # NVML's order differs from the bus order; the
        fake.add_gpu(minor=4 - i, uuid="not-a-uuid")  # files' UUIDs win
    backend = native.NativeBackend(nvml_library=str(fake.path))
    topo = backend.host_topology()
    assert topo.bounds == (5,) and backend.generation_source == "pci"
    specs = backend.enumerate_chips()
    assert [(s.index, s.uuid, s.paths, s.coord, s.numa_node, s.pci_device_id,
             s.pci_bus_id) for s in specs] == [
        (i, UUIDS[i], (f"/dev/nvidia{i}",), (i,), [0, 0, 1, 1, 1][i],
         ([0x2330] * 4 + [0x2331])[i], HOST[[1, 3, 0, 2, 4][i]].bus_id)
        for i in range(5)]
    assert [g.uuid_source for g in backend.gpus()] == ["proc"] * 5
    assert {s.generation for s in specs} == {"h100"}
    assert specs[0].hbm_bytes == 85520809984  # NVML's total
    assert backend.nvml_indices() == {4: 0, 3: 1, 2: 2, 1: 3, 0: 4}
    # the unknown PCI id is GUESSED, loudly
    guessed = [w for w in warnings if "GUESSED" in w["msg"]]
    assert [w.get("pci_device_id") for w in guessed] == ["0x2331"]
    assert backend.check_health() == {i: True for i in range(5)}
    chip_map = new_chip_map(backend, discover_resources("none"), "none")
    assert chip_map["nvidia.com/gpu"].ids() == sorted(UUIDS[:5])


def test_native_backend_on_a_host_that_hides_proc_and_sysfs(fake, tmp_path,
                                                            monkeypatch):
    """As the card's container shows it: device nodes (one the cgroup
    does not open, which NVML does not list), no information files, no
    PCI sysfs, NVML answering Not Supported for PCI and NUMA."""
    root = write_host(tmp_path / "root", [HostGpu("", 1, info=False),
                                          HostGpu("", 4, info=False)])
    monkeypatch.setenv("GPUENUM_ROOT", str(root))
    fake.add_gpu(minor=4, uuid=UUIDS[6])
    backend = native.NativeBackend(nvml_library=str(fake.path))
    (spec,) = backend.enumerate_chips()
    assert (spec.uuid, spec.paths, spec.numa_node, spec.pci_device_id,
            spec.pci_bus_id, spec.name) == (
        UUIDS[6], ("/dev/nvidia4",), -1, 0, "", "NVIDIA H100 80GB HBM3")
    assert backend.generation_source == "name"
    assert backend.gpus()[0].uuid_source == "nvml"
    assert backend.check_health() == {0: True}


def test_nvml_pci_id_decides_where_sysfs_is_hidden(fake, tmp_path, monkeypatch):
    root = write_host(tmp_path / "root", [HostGpu("", 0, info=False)])
    monkeypatch.setenv("GPUENUM_ROOT", str(root))
    fake.add_gpu(minor=0, uuid=UUIDS[0], bus_id="00000000:9B:00.0",
                 pci_device_id=0x2330, numa=1)
    backend = native.NativeBackend(nvml_library=str(fake.path))
    (spec,) = backend.enumerate_chips()
    assert backend.generation_source == "pci"
    assert (spec.numa_node, spec.pci_bus_id) == (1, "0000:9b:00.0")


def test_an_unknown_card_is_guessed_loudly(fake, tmp_path, monkeypatch,
                                          warnings):
    root = write_host(tmp_path / "root", [HostGpu("", 0, info=False)])
    monkeypatch.setenv("GPUENUM_ROOT", str(root))
    fake.add_gpu(minor=0, uuid=UUIDS[0], name="NVIDIA Mystery GPU")
    backend = native.NativeBackend(nvml_library=str(fake.path))
    assert backend.host_topology().generation.name == "h100"
    assert backend.generation_source == "unknown"
    assert any("GUESSED" in w["msg"] for w in warnings)
    # an operator's override is a claim, not a guess
    over = native.NativeBackend(topology_override="h100-1",
                                nvml_library=str(fake.path))
    over.host_topology()
    assert over.generation_source == "config"


def test_mig_instances_from_nvml_and_mig_minors(fake, tmp_path, monkeypatch):
    root = write_host(tmp_path / "root", [HOST[1], HOST[3]], MIG_MINORS)
    monkeypatch.setenv("GPUENUM_ROOT", str(root))
    g0 = fake.add_gpu(minor=0, uuid=UUIDS[0])
    fake.add_gpu(minor=1, uuid=UUIDS[1])
    fake.set_mig(g0)
    mig = ["MIG-00000000-1111-2222-3333-444444444444",
           "MIG-00000001-1111-2222-3333-444444444444"]
    fake.add_mig(g0, mig[0], "3g.40gb", 1, 0, 40 << 30)
    fake.add_mig(g0, mig[1], "3g.40gb", 2, 0, 40 << 30)
    backend = native.NativeBackend(nvml_library=str(fake.path))
    assert [s.mig_enabled for s in backend.enumerate_chips()] == [True, False]
    migs = backend.enumerate_mig()
    assert [(m.parent_index, m.uuid, m.profile, m.gi, m.ci, m.paths, m.hbm_bytes)
            for m in migs] == [
        (0, mig[0], "3g.40gb", 1, 0, ("/dev/nvidia0", "/dev/nvidia-caps/nvidia-cap12",
                                      "/dev/nvidia-caps/nvidia-cap13"), 40 << 30),
        (0, mig[1], "3g.40gb", 2, 0, ("/dev/nvidia0", "/dev/nvidia-caps/nvidia-cap21",
                                      "/dev/nvidia-caps/nvidia-cap22"), 40 << 30)]
    topo = backend.host_topology()
    chip_map = new_chip_map(backend, discover_resources("mixed", topo, "3g.40gb"),
                            "mixed")
    assert {k: v.ids() for k, v in chip_map.items()} == {
        "nvidia.com/gpu": [UUIDS[1]], "nvidia.com/mig-3g.40gb": mig}
    # an instance mig-minors does not list is an error, not a guess
    fake.add_mig(g0, "MIG-00000002-1111-2222-3333-444444444444", "1g.10gb", 9,
                 0, 10 << 30)
    with pytest.raises(RuntimeError, match="gpu0/gi9/ci0"):
        backend.enumerate_mig()


def test_make_backend_native_raises_on_an_empty_host(fake, tmp_path, monkeypatch):
    monkeypatch.setenv("GPUENUM_ROOT", str(tmp_path / "empty"))
    for kind in ("native", "auto"):
        with pytest.raises(RuntimeError, match="found no GPUs"):
            make_backend(kind, nvml_library=str(fake.path))
    assert fake.shutdowns() == 2  # each refused backend closed its session
    root = write_host(tmp_path / "root", [HostGpu("", 0, info=False)])
    monkeypatch.setenv("GPUENUM_ROOT", str(root))
    fake.add_gpu(minor=0, uuid=UUIDS[0])
    assert make_backend("native", nvml_library=str(fake.path)).name == "native"


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'gpuenum.cc: fatal: no room' >&2\nexit 4\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match="(?s)GPU enumerator.*exit 4.*no room"):
        make_backend("native")
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.NativeBackend()
