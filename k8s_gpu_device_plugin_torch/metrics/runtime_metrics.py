"""NVML usage reader: the usage side of the device metrics.

Port of the reference's ``metrics/runtime_metrics.py``. The reference
may not open the TPU runtime, which takes one client, so it scrapes the
gauges a workload serves on a gRPC port; no workload, no endpoint. NVML
is a library of the driver that any number of processes may read while a
workload runs, so :class:`NvmlUsageReader` reads it directly, with the
reference reader's ``read()``, ``read_status()``, cache TTL and
``usage_reader_from_config``:

- ``hbm_used_bytes`` is NVML's used device memory (the v2 call's, which
  leaves out the driver's own reservation);
- ``duty_cycle_percent`` is the ``gpu`` field of
  ``nvmlDeviceGetUtilizationRates``: the share of NVML's sample period in
  which a kernel ran;
- the reference's ``tensorcore_utilization`` has no NVML counter (NVML
  reports no tensor-core activity), so the reader reports none and the
  device metrics export no such sample rather than invent one.

A GPU is in the reading while a workload holds it: NVML lists a compute
process on it, or its memory is in use. ``read_status()``'s statuses are
the reference's, read so:

- ``"data"``   — NVML lists a compute process on a GPU;
- ``"silent"`` — the reader cannot tell: memory is held on a GPU but NVML
  lists no process (a container's PID namespace can hide them), this
  process holds the card itself, or NVML stopped answering for a GPU.
  The health assessor treats it as busy: its idle probe never runs;
- ``"absent"`` — no GPU is held: the host is idle.
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass

from k8s_gpu_device_plugin_torch.device.nvml import DEFAULT_LIBRARY, Nvml, NvmlError


@dataclass
class Usage:
    hbm_used_bytes: int = 0
    duty_cycle_percent: float = 0.0
    #: the compute processes NVML lists (pids in NVML's namespace)
    processes: tuple[int, ...] = ()


def this_process_holds_the_card() -> bool:
    """True when this process has started CUDA through torch (it then
    holds card memory, whether or not NVML lists it)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


class NvmlUsageReader:
    """Per-GPU usage from NVML. ``indices`` maps NVML's device index to
    the enumerator's GPU index (``NativeBackend.nvml_indices()``, joined
    by minor number); without it the keys are NVML's indices. One reader
    may serve two threads (the metrics handler and the health loop): a
    lock serializes reads, and ``cache_ttl_seconds`` > 0 lets
    near-simultaneous callers share one."""

    def __init__(
        self,
        nvml: "Nvml | None" = None,
        library: str = DEFAULT_LIBRARY,
        indices: "dict[int, int] | None" = None,
        cache_ttl_seconds: float = 0.0,
    ) -> None:
        self._owned = nvml is None
        self._nvml = nvml if nvml is not None else Nvml(library)
        self._indices = indices
        self._lock = threading.Lock()
        self._ttl = cache_ttl_seconds
        self._cache: tuple[float, dict[int, Usage], str] | None = None

    def close(self) -> None:
        with self._lock:
            self._cache = None
            if self._owned:
                self._nvml.shutdown()

    def read(self) -> dict[int, Usage]:
        return self.read_status()[0]

    def read_status(self) -> tuple[dict[int, Usage], str]:
        """Usages plus a status (see the module docstring)."""
        with self._lock:
            now = time.monotonic()
            if self._cache is not None and now - self._cache[0] < self._ttl:
                _, usages, status = self._cache
                return dict(usages), status
            usages, status = self._read_uncached()
            if self._ttl > 0:
                self._cache = (time.monotonic(), usages, status)
            return dict(usages), status

    def _read_uncached(self) -> tuple[dict[int, Usage], str]:
        nv = self._nvml
        usages: dict[int, Usage] = {}
        listed = cannot_tell = False
        for i in range(nv.device_count()):
            index = i if self._indices is None else self._indices.get(i)
            if index is None:
                continue
            try:
                h = nv.handle_by_index(i)
                mem = nv.memory_info(h)
                util = nv.utilization(h)
                procs = nv.compute_processes(h)
            except NvmlError:
                cannot_tell = True
                continue
            # v1 memory (no ``reserved``) counts the driver's reservation
            # as used: memory alone then says nothing
            held = mem.used > 0 if mem.reserved is not None else False
            if not procs and not held:
                continue
            usages[index] = Usage(hbm_used_bytes=mem.used,
                                  duty_cycle_percent=float(util.gpu),
                                  processes=tuple(p.pid for p in procs))
            listed = listed or bool(procs)
            cannot_tell = cannot_tell or not procs
        if not listed and this_process_holds_the_card():
            cannot_tell = True
        if listed:
            return usages, "data"
        return usages, "silent" if cannot_tell else "absent"


def usage_reader_from_config(cfg, backend=None):
    """The reader the ``runtimeMetricsPorts`` knob asks for: "off" -> the
    null reader; anything else -> NVML (the knob's port list has no
    meaning there). ``backend`` (a ``NativeBackend``) keys the readings
    by its GPU indices. The daemon's reader caches for
    ``runtime_metrics_cache_ttl`` seconds (default 2)."""
    from k8s_gpu_device_plugin_torch.metrics.device_metrics import NullUsageReader

    raw = getattr(cfg, "runtime_metrics_ports", "").strip()
    if raw.lower() == "off":
        return NullUsageReader()
    return NvmlUsageReader(
        nvml=getattr(backend, "nvml", None),
        indices=backend.nvml_indices() if backend is not None else None,
        cache_ttl_seconds=float(getattr(cfg, "runtime_metrics_cache_ttl", 2.0)),
    )
