"""Backend factory: the native GPU backend, or the fake when asked.

Port of the reference's ``device/factory.py`` without its silent
fallback. The reference's ``auto`` catches any native failure and
returns a fake v5e-4 host; on a node that would advertise devices that
do not exist. Here ``native`` and ``auto`` build the native backend or
raise with the compiler's or NVML's own message (or because it found no
GPU), and the synthetic backend comes only from ``kind="fake"``.
"""

from __future__ import annotations

from k8s_gpu_device_plugin_torch.device.backend import ChipBackend
from k8s_gpu_device_plugin_torch.device.fake import FakeBackend
from k8s_gpu_device_plugin_torch.device.nvml import DEFAULT_LIBRARY


def make_backend(kind: str = "auto", topology: str = "auto",
                 nvml_library: str = DEFAULT_LIBRARY) -> ChipBackend:
    """Build a GPU backend.

    ``kind`` "native" or "auto" (the same) needs the C++ enumerator and
    NVML (``nvml_library``), and raises when either fails or no GPU is
    found; "fake" is the synthetic backend, an ``h100-8`` host unless
    ``topology`` names one.
    """
    if kind == "fake":
        return FakeBackend("h100-8" if topology == "auto" else topology)
    if kind not in ("auto", "native"):
        raise ValueError(f"unknown backend kind {kind!r} (auto, native, fake)")
    from k8s_gpu_device_plugin_torch.device.native import NativeBackend

    backend = NativeBackend(topology_override=topology, nvml_library=nvml_library)
    if not backend.available():
        backend.close()
        raise RuntimeError("native GPU enumeration found no GPUs")
    return backend
