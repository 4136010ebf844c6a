"""A fake NVML and a synthetic host tree, for driving the native backend
with no GPU.

``FakeNvml.build(dir)`` compiles a small C library that exports the NVML
calls ``device/nvml.py`` binds (built with ``$CXX`` or ``g++`` as C++, one
file, no NVIDIA header). Its devices are set through the library's own
``fake_*`` functions, wrapped here; ``Nvml(fake.path)`` then reads them
as it reads ``libnvidia-ml.so.1``. ``write_host(root, gpus)`` lays out the
``/dev``, ``/proc/driver/nvidia`` and ``/sys`` files ``native/gpuenum.cc``
reads under ``$GPUENUM_ROOT``.

Usage::

    fake = FakeNvml.build(tmp_path)
    fake.add_gpu(minor=0, uuid="GPU-…", name="NVIDIA H100 80GB HBM3")
    write_host(tmp_path / "root", [HostGpu("0000:18:00.0", 0)])
    monkeypatch.setenv("GPUENUM_ROOT", str(tmp_path / "root"))
    backend = NativeBackend(nvml_library=str(fake.path))
"""

from __future__ import annotations

import ctypes
import subprocess
from dataclasses import dataclass
from pathlib import Path

from k8s_gpu_device_plugin_torch.utils.native_build import find_cxx

FAKE_NVML_SOURCE = r"""
#include <stdio.h>
#include <string.h>

extern "C" {

typedef unsigned long long ull;
enum { MAXDEV = 16, MAXPROC = 8 };

struct Dev {
  int used, minor, lost, parent, gi, ci, numa;
  unsigned util, pci_device_id, mig;
  ull total, used_bytes, reserved;
  char uuid[96], name[96], bus[32];
  unsigned nproc, pids[MAXPROC];
  ull proc_bytes[MAXPROC];
};

static Dev devs[MAXDEV];     // GPUs first, then MIG devices
static int ndevs = 0, ngpus = 0, inits = 0, shutdowns = 0;
static int init_error = 0, v2 = 1;

static Dev* dev(void* h) {
  Dev* d = (Dev*)h;
  return (d >= devs && d < devs + ndevs) ? d : 0;
}

// --- the fake's own controls -------------------------------------------
int fake_add(int parent, int minor, const char* uuid, const char* name,
             ull total, const char* bus, unsigned pci_device_id, int numa) {
  if (ndevs == MAXDEV) return -1;
  Dev* d = &devs[ndevs];
  memset(d, 0, sizeof(*d));
  d->used = 1; d->minor = minor; d->parent = parent; d->numa = numa;
  d->total = total; d->reserved = total / 160; d->pci_device_id = pci_device_id;
  snprintf(d->uuid, sizeof(d->uuid), "%s", uuid);
  snprintf(d->name, sizeof(d->name), "%s", name);
  snprintf(d->bus, sizeof(d->bus), "%s", bus);
  if (parent < 0) ++ngpus;
  return ndevs++;
}
void fake_set_usage(int i, ull used, unsigned util) {
  devs[i].used_bytes = used; devs[i].util = util;
}
void fake_set_procs(int i, unsigned n, const unsigned* pids, const ull* bytes) {
  devs[i].nproc = n;
  for (unsigned k = 0; k < n && k < MAXPROC; ++k) {
    devs[i].pids[k] = pids[k]; devs[i].proc_bytes[k] = bytes[k];
  }
}
void fake_set_lost(int i, int lost) { devs[i].lost = lost; }
void fake_set_mig(int i, unsigned mode) { devs[i].mig = mode; }
void fake_set_instance(int i, int gi, int ci) { devs[i].gi = gi; devs[i].ci = ci; }
void fake_set_init_error(int code) { init_error = code; }
void fake_set_memory_v2(int on) { v2 = on; }
int fake_inits(void) { return inits; }
int fake_shutdowns(void) { return shutdowns; }

// --- NVML ----------------------------------------------------------------
const char* nvmlErrorString(int r) {
  switch (r) {
    case 0: return "Success";
    case 1: return "Uninitialized";
    case 2: return "Invalid Argument";
    case 3: return "Not Supported";
    case 6: return "Not Found";
    case 7: return "Insufficient Size";
    case 9: return "Driver Not Loaded";
    case 15: return "GPU is lost";
  }
  return "Unknown Error";
}
int nvmlInit_v2(void) { if (init_error) return init_error; ++inits; return 0; }
int nvmlShutdown(void) { ++shutdowns; return 0; }
int nvmlDeviceGetCount_v2(unsigned* n) { *n = ngpus; return 0; }
int nvmlDeviceGetHandleByIndex_v2(unsigned i, void** h) {
  int seen = 0;
  for (int k = 0; k < ndevs; ++k)
    if (devs[k].parent < 0 && seen++ == (int)i) { *h = &devs[k]; return 0; }
  return 2;
}
int nvmlDeviceGetHandleByUUID(const char* uuid, void** h) {
  for (int k = 0; k < ndevs; ++k)
    if (strcmp(devs[k].uuid, uuid) == 0) { *h = &devs[k]; return 0; }
  return 6;
}
#define DEV(h) Dev* d = dev(h); if (!d) return 2; if (d->lost) return 15
static int copy(char* out, unsigned len, const char* s) {
  if (strlen(s) + 1 > len) return 7;
  snprintf(out, len, "%s", s);
  return 0;
}
int nvmlDeviceGetName(void* h, char* out, unsigned len) { DEV(h); return copy(out, len, d->name); }
int nvmlDeviceGetUUID(void* h, char* out, unsigned len) { DEV(h); return copy(out, len, d->uuid); }
int nvmlDeviceGetMinorNumber(void* h, unsigned* m) { DEV(h); *m = d->minor; return 0; }
int nvmlDeviceGetMemoryInfo(void* h, ull* m) {
  DEV(h);
  m[0] = d->total; m[2] = d->used_bytes + d->reserved; m[1] = d->total - m[2];
  return 0;
}
struct MemV2 { unsigned version; ull total, reserved, free, used; };
int nvmlDeviceGetMemoryInfo_v2(void* h, MemV2* m) {
  DEV(h);
  if (!v2) return 3;
  m->total = d->total; m->reserved = d->reserved; m->used = d->used_bytes;
  m->free = d->total - d->reserved - d->used_bytes;
  return 0;
}
int nvmlDeviceGetUtilizationRates(void* h, unsigned* u) {
  DEV(h); u[0] = d->util; u[1] = d->util / 3; return 0;
}
struct Proc { unsigned pid; ull used; unsigned gi, ci; };
int nvmlDeviceGetComputeRunningProcesses_v3(void* h, unsigned* n, Proc* out) {
  DEV(h);
  if (*n < d->nproc) { *n = d->nproc; return 7; }
  for (unsigned k = 0; k < d->nproc; ++k) {
    out[k].pid = d->pids[k]; out[k].used = d->proc_bytes[k];
    out[k].gi = out[k].ci = 0xffffffffu;
  }
  *n = d->nproc;
  return 0;
}
struct Pci { char legacy[16]; unsigned domain, bus, device, id, sub; char bus_id[32]; };
int nvmlDeviceGetPciInfo_v3(void* h, Pci* p) {
  DEV(h);
  if (!d->pci_device_id) return 3;
  memset(p, 0, sizeof(*p));
  p->id = (d->pci_device_id << 16) | 0x10de;
  snprintf(p->bus_id, sizeof(p->bus_id), "%s", d->bus);
  return 0;
}
int nvmlDeviceGetNumaNodeId(void* h, unsigned* n) {
  DEV(h); if (d->numa < 0) return 3; *n = d->numa; return 0;
}
int nvmlDeviceGetMigMode(void* h, unsigned* cur, unsigned* pend) {
  DEV(h); *cur = d->mig; *pend = d->mig; return 0;
}
int nvmlDeviceGetMaxMigDeviceCount(void* h, unsigned* n) { DEV(h); *n = 7; return 0; }
int nvmlDeviceGetMigDeviceHandleByIndex(void* h, unsigned i, void** out) {
  DEV(h);
  const int parent = (int)(d - devs);
  unsigned seen = 0;
  for (int k = 0; k < ndevs; ++k)
    if (devs[k].parent == parent && seen++ == i) { *out = &devs[k]; return 0; }
  return 6;
}
int nvmlDeviceGetGpuInstanceId(void* h, unsigned* id) { DEV(h); *id = d->gi; return 0; }
int nvmlDeviceGetComputeInstanceId(void* h, unsigned* id) { DEV(h); *id = d->ci; return 0; }

}  // extern "C"
"""


class FakeNvml:
    """A built fake ``libnvidia-ml`` and handles on its controls."""

    def __init__(self, path: Path) -> None:
        self.path = Path(path)
        self._lib = ctypes.CDLL(str(self.path))
        c = ctypes
        for name, argtypes in {
            "fake_add": [c.c_int, c.c_int, c.c_char_p, c.c_char_p,
                         c.c_ulonglong, c.c_char_p, c.c_uint, c.c_int],
            "fake_set_usage": [c.c_int, c.c_ulonglong, c.c_uint],
            "fake_set_procs": [c.c_int, c.c_uint, c.POINTER(c.c_uint),
                               c.POINTER(c.c_ulonglong)],
            "fake_set_lost": [c.c_int, c.c_int],
            "fake_set_mig": [c.c_int, c.c_uint],
            "fake_set_instance": [c.c_int, c.c_int, c.c_int],
            "fake_set_init_error": [c.c_int],
            "fake_set_memory_v2": [c.c_int],
            "fake_inits": [],
            "fake_shutdowns": [],
        }.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = c.c_int if name in ("fake_add", "fake_inits",
                                             "fake_shutdowns") else None

    @staticmethod
    def build(directory: Path) -> "FakeNvml":
        """Compile the fake into ``directory`` (a fresh library, so its
        state starts empty)."""
        cxx = find_cxx()
        if cxx is None:
            raise RuntimeError("no C++ compiler for the fake NVML")
        directory = Path(directory)
        src, out = directory / "fake_nvml.cc", directory / "libfake_nvml.so"
        src.write_text(FAKE_NVML_SOURCE)
        subprocess.run([*cxx, "-O1", "-fPIC", "-shared", "-o", str(out),
                        str(src)], check=True, capture_output=True, timeout=120)
        return FakeNvml(out)

    def add_gpu(self, minor: int, uuid: str, name: str = "NVIDIA H100 80GB HBM3",
                total: int = 85520809984, bus_id: str = "",
                pci_device_id: int = 0, numa: int = -1) -> int:
        """A GPU; ``pci_device_id`` 0 answers PCI queries Not Supported,
        ``numa`` -1 the NUMA query. Returns its fake index."""
        return self._lib.fake_add(-1, minor, uuid.encode(), name.encode(), total,
                                  bus_id.encode(), pci_device_id, numa)

    def add_mig(self, parent: int, uuid: str, profile: str, gi: int, ci: int,
                total: int) -> int:
        i = self._lib.fake_add(parent, 0, uuid.encode(),
                               f"NVIDIA H100 80GB HBM3 MIG {profile}".encode(),
                               total, b"", 0, -1)
        self._lib.fake_set_instance(i, gi, ci)
        return i

    def set_usage(self, i: int, used: int, util: int) -> None:
        self._lib.fake_set_usage(i, used, util)

    def set_procs(self, i: int, procs: "list[tuple[int, int]]") -> None:
        pids = (ctypes.c_uint * max(1, len(procs)))(*[p for p, _ in procs])
        used = (ctypes.c_ulonglong * max(1, len(procs)))(*[b for _, b in procs])
        self._lib.fake_set_procs(i, len(procs), pids, used)

    def set_lost(self, i: int, lost: bool = True) -> None:
        self._lib.fake_set_lost(i, int(lost))

    def set_mig(self, i: int, enabled: bool = True) -> None:
        self._lib.fake_set_mig(i, int(enabled))

    def set_init_error(self, code: int) -> None:
        self._lib.fake_set_init_error(code)

    def set_memory_v2(self, on: bool) -> None:
        self._lib.fake_set_memory_v2(int(on))

    def inits(self) -> int:
        return self._lib.fake_inits()

    def shutdowns(self) -> int:
        return self._lib.fake_shutdowns()


@dataclass(frozen=True)
class HostGpu:
    """One device of a synthetic host: an information file (unless
    ``info`` is False), its sysfs PCI files and its device node."""

    bus_id: str
    minor: int
    uuid: str = ""
    model: str = "NVIDIA H100 80GB HBM3"
    vendor: int = 0x10de
    device: int = 0x2330
    numa_node: int = 0
    info: bool = True


def write_host(root: Path, gpus: "list[HostGpu]", mig_minors: str = "") -> Path:
    """Lay out ``gpus`` under ``root`` as ``native/gpuenum.cc`` reads a host."""
    root = Path(root)
    (root / "dev").mkdir(parents=True, exist_ok=True)
    for g in gpus:
        (root / "dev" / f"nvidia{g.minor}").write_text("")
        if not g.info:
            continue
        proc = root / "proc/driver/nvidia/gpus" / g.bus_id
        proc.mkdir(parents=True, exist_ok=True)
        (proc / "information").write_text(
            f"Model: \t\t {g.model}\nIRQ:   \t\t 42\nGPU UUID: \t {g.uuid}\n"
            f"Bus Location: \t {g.bus_id}\nDevice Minor: \t {g.minor}\n")
        sys_dir = root / "sys/bus/pci/devices" / g.bus_id
        sys_dir.mkdir(parents=True, exist_ok=True)
        (sys_dir / "vendor").write_text(f"0x{g.vendor:04x}\n")
        (sys_dir / "device").write_text(f"0x{g.device:04x}\n")
        (sys_dir / "numa_node").write_text(f"{g.numa_node}\n")
    if mig_minors:
        caps = root / "proc/driver/nvidia-caps"
        caps.mkdir(parents=True, exist_ok=True)
        (caps / "mig-minors").write_text(mig_minors)
    return root
