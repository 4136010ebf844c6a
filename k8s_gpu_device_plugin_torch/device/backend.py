"""GPU enumeration backend seam.

Port of the reference's ``device/backend.py``. One seam, ``ChipBackend``,
two implementations:

- ``FakeBackend`` (device/fake.py): hosts as data, for tests and the
  zero-hardware control-plane path;
- ``NativeBackend`` (device/native.py): ctypes bindings over the C++
  enumerator (``native/gpuenum.cc``: ``/dev/nvidia*``,
  ``/proc/driver/nvidia`` and sysfs) and NVML (``device/nvml.py``).

A GPU is a ``ChipSpec``; a MIG instance that exists on one is a
``MigSpec`` (the Go original's ``VisitMigDevices``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

from k8s_gpu_device_plugin_torch.device.topology import HostTopology


@dataclass(frozen=True)
class ChipSpec:
    """Raw facts about one physical GPU, as reported by a backend."""

    index: int
    uuid: str
    paths: tuple[str, ...]
    coord: tuple[int, ...]
    numa_node: int
    hbm_bytes: int
    generation: str
    name: str = ""            # the model name (NVML / torch's device name)
    pci_bus_id: str = ""      # "0000:18:00.0"
    pci_device_id: int = 0    # vendor 0x10de's device id (0x2330: H100 SXM5)
    mig_enabled: bool = False  # MIG mode as found (never switched here)


@dataclass(frozen=True)
class MigSpec:
    """One MIG instance (a GPU instance and its compute instance) that
    exists on a GPU."""

    parent_index: int
    uuid: str                 # MIG-…
    profile: str              # "1g.10gb"
    gi: int                   # GPU instance id
    ci: int                   # compute instance id
    paths: tuple[str, ...]    # parent node, GI and CI capability nodes
    hbm_bytes: int
    start: int = -1           # first memory slice, -1 when not known


@runtime_checkable
class ChipBackend(Protocol):
    """Enumeration + health backend for one host's GPUs."""

    name: str

    def host_topology(self) -> HostTopology: ...

    def enumerate_chips(self) -> list[ChipSpec]: ...

    def enumerate_mig(self) -> list[MigSpec]: ...

    def check_health(self) -> dict[int, bool]:
        """Current health per GPU index (True = healthy)."""
        ...
