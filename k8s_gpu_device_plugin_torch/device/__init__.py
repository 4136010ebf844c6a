"""Device model and enumeration (port of the reference's ``device/``).

The reference models a TPU host: chips on an ICI mesh, enumerated by a
backend (fake for tests, a C++ core on hosts), with ICI sub-slices in
place of the Go original's MIG. The port models NVIDIA GPUs and takes
the Go original's names back: whole GPUs are ``nvidia.com/gpu``, MIG
instances ``nvidia.com/mig-<profile>`` (device/slices.py), enumerated
from ``/dev/nvidia*``, ``/proc/driver/nvidia``, sysfs
(``native/gpuenum.cc``) and NVML (device/nvml.py).

``resolve_device`` (device/select.py), the entry points' CUDA-or-CPU
gate, is exported here too; it is loaded on first use, so the device
model itself imports no torch.
"""

from k8s_gpu_device_plugin_torch.device.backend import ChipBackend, ChipSpec, MigSpec
from k8s_gpu_device_plugin_torch.device.chip import AnnotatedID, Chip, Chips
from k8s_gpu_device_plugin_torch.device.chip_map import ChipMap, new_chip_map
from k8s_gpu_device_plugin_torch.device.fake import FakeBackend
from k8s_gpu_device_plugin_torch.device.slices import (
    SlicePlacement,
    SliceProfile,
    partition_host,
    supported_profiles,
)
from k8s_gpu_device_plugin_torch.device.topology import (
    GENERATIONS,
    GpuGeneration,
    HostTopology,
    parse_topology,
)

__all__ = [
    "AnnotatedID",
    "Chip",
    "Chips",
    "ChipMap",
    "new_chip_map",
    "ChipBackend",
    "ChipSpec",
    "MigSpec",
    "FakeBackend",
    "GENERATIONS",
    "HostTopology",
    "GpuGeneration",
    "parse_topology",
    "SliceProfile",
    "SlicePlacement",
    "partition_host",
    "supported_profiles",
    "resolve_device",
]


def __getattr__(name: str):
    if name == "resolve_device":
        from k8s_gpu_device_plugin_torch.device.select import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
