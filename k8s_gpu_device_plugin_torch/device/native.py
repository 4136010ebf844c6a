"""The native GPU backend: ``native/gpuenum.cc`` joined to NVML.

Port of the reference's ``device/native.py``. The C++ enumerator
(``libgpuenum``, built at first use by ``utils/native_build.py``) reads
``/dev/nvidia*``, ``/proc/driver/nvidia/gpus/*/information``, sysfs and
``mig-minors``; NVML (device/nvml.py) gives the name, memory, MIG
instances and health. The two are joined by the device's minor number,
which both always carry.

A host may hide parts of this (a container without ``/proc/driver/nvidia/
gpus`` or PCI sysfs, an NVML that answers "Not Supported" for PCI and
NUMA). Each fact then comes from the next source that gives it, and none
is made up:

- the UUID from the information file, else NVML's; a GPU with neither is
  left out. ``uuid_source`` records which, per GPU;
- the generation from the PCI device id (sysfs, else NVML), source
  ``pci``; else from the driver's model name, source ``name``; else a
  guess, logged loudly (``GUESSED``), source ``unknown``;
- the NUMA node from sysfs, else NVML, else -1; the memory from NVML's
  total, else the generation table.

A device node that neither an information file nor NVML describes (one
the container's cgroup does not open) is not a GPU of this host's view
and is left out.
"""

from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass

from k8s_gpu_device_plugin_torch.device.backend import ChipSpec, MigSpec
from k8s_gpu_device_plugin_torch.device.nvml import (
    DEFAULT_LIBRARY,
    Nvml,
    NvmlError,
    is_uuid,
    mig_profile_of,
)
from k8s_gpu_device_plugin_torch.device.slices import mig_paths
from k8s_gpu_device_plugin_torch.device.topology import (
    GENERATIONS,
    HostTopology,
    generation_for_device_kind,
    parse_topology,
)
from k8s_gpu_device_plugin_torch.utils import native_build
from k8s_gpu_device_plugin_torch.utils.log import get_logger

SOURCE = native_build.NATIVE_DIR / "gpuenum.cc"
HEADER = native_build.NATIVE_DIR / "gpuenum.h"
#: gpuenum_generation_source() values (native/gpuenum.h GPUENUM_GEN_*)
GEN_SOURCE_NAMES = {0: "unknown", 1: "pci"}


class _CGpuInfo(ctypes.Structure):
    """Mirrors ``GpuEnumInfo`` in native/gpuenum.h."""

    _fields_ = [
        ("index", ctypes.c_int32),
        ("minor", ctypes.c_int32),
        ("numa_node", ctypes.c_int32),
        ("has_info", ctypes.c_int32),
        ("pci_vendor_id", ctypes.c_uint32),
        ("pci_device_id", ctypes.c_uint32),
        ("uuid", ctypes.c_char * 96),
        ("model", ctypes.c_char * 96),
        ("bus_id", ctypes.c_char * 32),
        ("path", ctypes.c_char * 64),
        ("generation", ctypes.c_char * 16),
    ]


class _CMigCap(ctypes.Structure):
    """Mirrors ``GpuEnumMigCap`` in native/gpuenum.h."""

    _fields_ = [("gpu_minor", ctypes.c_int32), ("gi", ctypes.c_int32),
                ("ci", ctypes.c_int32), ("cap_minor", ctypes.c_int32)]


_lib: "ctypes.CDLL | None" = None
_lib_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """Build (once per source, compiler and flags) and load the
    enumerator; cached per process. Raises with the compiler's own
    message when it cannot be built."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native_build.build_library(
                "gpuenum", SOURCE, "the GPU enumerator", headers=(HEADER,))))
            for fn in ("gpuenum_gpu_count", "gpuenum_generation_source",
                       "gpuenum_mig_count"):
                getattr(lib, fn).restype = ctypes.c_int32
            lib.gpuenum_enumerate.restype = ctypes.c_int32
            lib.gpuenum_enumerate.argtypes = [ctypes.POINTER(_CGpuInfo),
                                              ctypes.c_int32]
            lib.gpuenum_generation.restype = ctypes.c_int32
            lib.gpuenum_generation.argtypes = [ctypes.c_char_p, ctypes.c_int32]
            lib.gpuenum_generation_of.restype = ctypes.c_int32
            lib.gpuenum_generation_of.argtypes = [ctypes.c_uint32,
                                                  ctypes.c_char_p, ctypes.c_int32]
            lib.gpuenum_mig_enumerate.restype = ctypes.c_int32
            lib.gpuenum_mig_enumerate.argtypes = [ctypes.POINTER(_CMigCap),
                                                  ctypes.c_int32]
            _lib = lib
        return _lib


def enumerate_raw(lib: ctypes.CDLL) -> list[_CGpuInfo]:
    count = lib.gpuenum_gpu_count()
    buf = (_CGpuInfo * max(1, count))()
    return list(buf[:max(0, lib.gpuenum_enumerate(buf, count))])


def mig_caps(lib: ctypes.CDLL) -> dict[tuple[int, int, int], int]:
    """``mig-minors`` as {(gpu minor, gi, ci): capability minor}, ci -1
    for a GPU instance's own line."""
    count = lib.gpuenum_mig_count()
    buf = (_CMigCap * max(1, count))()
    n = max(0, lib.gpuenum_mig_enumerate(buf, count))
    return {(c.gpu_minor, c.gi, c.ci): c.cap_minor for c in buf[:n]}


def generation_of(lib: ctypes.CDLL, pci_device_id: int) -> str:
    out = ctypes.create_string_buffer(16)
    lib.gpuenum_generation_of(pci_device_id, out, len(out))
    return out.value.decode()


def _bus_key(bus_id: "str | None") -> "str | None":
    """``00000000:9B:00.0`` / ``0000:9b:00.0`` -> ``0000:9b:00.0``."""
    if not bus_id:
        return None
    domain, _, rest = bus_id.strip().lower().rpartition(":")
    domain, _, bus = domain.rpartition(":") if domain.count(":") else ("", "", domain)
    try:
        return f"{int(domain or '0', 16):04x}:{bus}:{rest}"
    except ValueError:
        return None


@dataclass
class Gpu:
    """One GPU as the sources joined it."""

    minor: int
    path: str
    uuid: str = ""
    uuid_source: str = ""       # proc (information file) / nvml
    name: str = ""
    bus_id: "str | None" = None
    numa_node: int = -1
    pci_device_id: int = 0
    hbm_bytes: int = 0
    nvml_index: "int | None" = None
    mig_enabled: bool = False


class NativeBackend:
    """GPU backend over the C++ enumerator and NVML. Construction builds
    the enumerator and opens NVML, and raises with the compiler's or
    NVML's own message when either fails."""

    name = "native"

    def __init__(self, topology_override: str = "auto",
                 nvml_library: str = DEFAULT_LIBRARY) -> None:
        self._lib = load_library()
        self._nvml = Nvml(nvml_library)
        self._topology_override = topology_override
        self._topo: HostTopology | None = None
        self._found: "list[Gpu] | None" = None
        #: where the generation came from: "pci" (the PCI device id),
        #: "name" (the driver's model name), "config" (an operator's
        #: override) or "unknown" (a guess, logged as GUESSED)
        self.generation_source = "unknown"

    @property
    def nvml(self) -> Nvml:
        return self._nvml

    def close(self) -> None:
        self._nvml.shutdown()

    def available(self) -> bool:
        return bool(self.gpus())

    # --- discovery ---------------------------------------------------------

    def gpus(self) -> list[Gpu]:
        """Every GPU of the host, joined across the sources, in the
        enumerator's order (PCI bus id where known, then minor). Read once,
        as the reference fixes its topology once: indices stay stable, and
        a GPU that fails later reads unhealthy under its own index."""
        if self._found is None:
            self._found = self._discover()
        return self._found

    def _discover(self) -> list[Gpu]:
        nvml_by_minor: dict[int, int] = {}
        for i in range(self._nvml.device_count()):
            try:
                minor = self._nvml.minor_number(self._nvml.handle_by_index(i))
            except NvmlError:  # lost before it could be joined
                continue
            nvml_by_minor[minor] = i
        found: list[Gpu] = []
        for info in enumerate_raw(self._lib):
            nv = nvml_by_minor.pop(int(info.minor), None)
            if nv is None and not info.has_info:
                continue  # a node no source describes
            found.append(Gpu(
                minor=int(info.minor), path=info.path.decode(),
                uuid=info.uuid.decode(), name=info.model.decode(),
                bus_id=_bus_key(info.bus_id.decode()),
                numa_node=int(info.numa_node),
                pci_device_id=int(info.pci_device_id), nvml_index=nv))
        found += [Gpu(minor=m, path=f"/dev/nvidia{m}", nvml_index=i)
                  for m, i in nvml_by_minor.items()]
        for gpu in found:
            if gpu.nvml_index is not None:
                self._fill_from_nvml(gpu)
        found.sort(key=lambda g: (g.bus_id is None, g.bus_id or "", g.minor))
        return self._identified(found)

    def _fill_from_nvml(self, gpu: Gpu) -> None:
        """What NVML adds; a GPU that stops answering half way keeps what
        was read (check_health reports it)."""
        nv = self._nvml
        try:
            h = nv.handle_by_index(gpu.nvml_index)
            if is_uuid(gpu.uuid):
                gpu.uuid_source = "proc"
            elif is_uuid(uuid := nv.uuid(h)):
                gpu.uuid, gpu.uuid_source = uuid, "nvml"
            gpu.name = gpu.name or nv.name(h)
            gpu.mig_enabled = nv.mig_mode(h)[0] == 1
            gpu.bus_id = gpu.bus_id or _bus_key(nv.pci_bus_id(h))
            gpu.pci_device_id = gpu.pci_device_id or nv.pci_device_id(h) or 0
            if gpu.numa_node < 0:
                numa = nv.numa_node(h)
                gpu.numa_node = -1 if numa is None else numa
            gpu.hbm_bytes = nv.memory_info(h).total
        except NvmlError as e:
            get_logger().warning("NVML stopped answering for a GPU",
                                 extra={"fields": {"gpu": gpu.path,
                                                   "error": str(e)}})

    @staticmethod
    def _identified(found: list[Gpu]) -> list[Gpu]:
        """The GPUs with a UUID; one without (no information file, and
        NVML stopped answering before it gave one) is left out, loudly:
        a device ID is never made up."""
        for gpu in found:
            if not gpu.uuid_source and is_uuid(gpu.uuid):
                gpu.uuid_source = "proc"
            if not gpu.uuid_source:
                get_logger().warning(
                    "GPU left out: no information file and no UUID from NVML",
                    extra={"fields": {"gpu": gpu.path}})
        return [g for g in found if g.uuid_source]

    # --- the ChipBackend protocol ------------------------------------------

    def _generation(self, found: list[Gpu]) -> str:
        out = ctypes.create_string_buffer(16)
        self._lib.gpuenum_generation(out, len(out))
        name = out.value.decode()
        source = GEN_SOURCE_NAMES.get(int(self._lib.gpuenum_generation_source()),
                                      "unknown")
        log = get_logger()
        for gpu in found:
            if gpu.pci_device_id and not generation_of(self._lib, gpu.pci_device_id):
                log.warning(
                    "GPU generation is GUESSED: the table does not know PCI "
                    "device id; figures derived from the generation table "
                    "may be wrong for this GPU",
                    extra={"fields": {"gpu": gpu.path,
                                      "pci_device_id": hex(gpu.pci_device_id)}})
        if source != "pci":
            known = [generation_of(self._lib, g.pci_device_id)
                     for g in found if g.pci_device_id]
            named = [generation_for_device_kind(g.name) for g in found if g.name]
            if any(known):
                name, source = next(k for k in known if k), "pci"
            elif any(named):
                name, source = next(n for n in named if n), "name"
        if name not in GENERATIONS:
            name, source = "h100", "unknown"
            log.warning(
                "GPU generation is GUESSED, not measured from a PCI id or "
                "the driver's model name; figures derived from the "
                "generation table may be wrong on this host",
                extra={"fields": {"generation": name, "source": source}})
        self.generation_source = source
        return name

    def host_topology(self) -> HostTopology:
        if self._topo is not None:
            return self._topo
        found = self.gpus()
        measured = self._generation(found)
        if self._topology_override not in ("", "auto"):
            topo = parse_topology(self._topology_override)
            if self.generation_source != "unknown" and measured != topo.generation.name:
                get_logger().warning(
                    "configured topology generation disagrees with the "
                    "measured generation; honoring the config",
                    extra={"fields": {"configured": topo.generation.name,
                                      "measured": measured}})
            self.generation_source = "config"
        else:
            topo = parse_topology(f"{measured}-{max(1, len(found))}")
        self._topo = topo
        return topo

    def enumerate_chips(self) -> list[ChipSpec]:
        topo = self.host_topology()
        coords = topo.coords()
        gen = topo.generation
        return [
            ChipSpec(
                index=i,
                uuid=gpu.uuid,
                paths=(gpu.path,),
                coord=coords[i] if i < len(coords) else (i,),
                numa_node=gpu.numa_node,
                hbm_bytes=gpu.hbm_bytes or gen.hbm_bytes,
                generation=gen.name,
                name=gpu.name,
                pci_bus_id=gpu.bus_id or "",
                pci_device_id=gpu.pci_device_id,
                mig_enabled=gpu.mig_enabled,
            )
            for i, gpu in enumerate(self.gpus())
        ]

    def enumerate_mig(self) -> list[MigSpec]:
        """The MIG instances that exist, read from NVML, with their
        capability nodes from ``mig-minors``."""
        caps = mig_caps(self._lib)
        out = []
        nv = self._nvml
        for index, gpu in enumerate(self.gpus()):
            if not gpu.mig_enabled or gpu.nvml_index is None:
                continue
            for mh in nv.mig_devices(nv.handle_by_index(gpu.nvml_index)):
                gi, ci = nv.gpu_instance_id(mh), nv.compute_instance_id(mh)
                try:
                    gi_cap, ci_cap = caps[(gpu.minor, gi, -1)], caps[(gpu.minor, gi, ci)]
                except KeyError:
                    raise RuntimeError(
                        f"mig-minors has no capability line for gpu{gpu.minor}/"
                        f"gi{gi}/ci{ci}") from None
                out.append(MigSpec(
                    parent_index=index, uuid=nv.uuid(mh),
                    profile=mig_profile_of(nv.name(mh)), gi=gi, ci=ci,
                    paths=mig_paths(gpu.minor, gi_cap, ci_cap),
                    hbm_bytes=nv.memory_info(mh).total))
        return out

    def nvml_indices(self) -> dict[int, int]:
        """NVML device index -> the GPU's index here (joined by minor)."""
        return {gpu.nvml_index: i for i, gpu in enumerate(self.gpus())
                if gpu.nvml_index is not None}

    def check_health(self) -> dict[int, bool]:
        """A GPU is healthy while its device node exists and is readable
        and NVML answers for it (by UUID where NVML gives UUIDs; by its
        handle otherwise). ``NVML_ERROR_GPU_IS_LOST``, or any other NVML
        error, is unhealthy."""
        root = os.environ.get("GPUENUM_ROOT", "")
        out: dict[int, bool] = {}
        for i, gpu in enumerate(self.gpus()):
            path = root + gpu.path
            ok = (os.path.exists(path) and os.access(path, os.R_OK)
                  and gpu.nvml_index is not None)
            if ok:
                try:
                    h = (self._nvml.handle_by_uuid(gpu.uuid)
                         if gpu.uuid_source == "nvml"
                         else self._nvml.handle_by_index(gpu.nvml_index))
                    self._nvml.memory_info(h)
                except NvmlError:
                    ok = False
            out[i] = ok
        return out
