"""Per-GPU device metrics on the port's registry.

Port of the reference's ``metrics/device_metrics.py``. The reference's
gauges sit on ``prometheus_client`` and its process-global registry;
the card's machine has no ``prometheus_client``, so these sit on
``metrics/exposition.py``'s ``Registry``, which the caller passes in.
The families (the prefix is the port's, as ``gpu_serving_*``):

- ``gpu_plugin_chips{resource,state}``              devices per resource
- ``gpu_plugin_chip_hbm_total_bytes{chip,generation}`` memory per GPU
- ``gpu_plugin_chip_hbm_used_bytes{chip}``          memory in use (NVML)
- ``gpu_plugin_chip_duty_cycle_percent{chip}``      kernel duty cycle (NVML)
- ``gpu_plugin_generation_guessed{generation,source}``
- ``gpu_plugin_build_info{version}``

The reference's ``tensorcore_utilization`` family is left out: NVML has
no tensor-core activity counter, and no sample is better than a made-up
one. Inventory and capacity come from the chip map; usage from a
``UsageReader`` (``metrics/runtime_metrics.py`` ``NvmlUsageReader``),
with the reference's rule that a GPU whose workload is gone has its
usage gauges zeroed rather than left at the last reading.
"""

from __future__ import annotations

import threading
from typing import Protocol

from k8s_gpu_device_plugin_torch.device.chip import HEALTHY, UNKNOWN, AnnotatedID
from k8s_gpu_device_plugin_torch.device.chip_map import ChipMap
from k8s_gpu_device_plugin_torch.metrics.exposition import Gauge, Registry
from k8s_gpu_device_plugin_torch.utils.version import VERSION

PREFIX = "gpu_plugin_"


class ChipUsage(Protocol):
    hbm_used_bytes: int
    duty_cycle_percent: float


class UsageReader(Protocol):
    def read(self) -> dict[int, ChipUsage]:
        """Best-effort usage per physical GPU index; empty if unavailable."""
        ...


class NullUsageReader:
    def read(self) -> dict[int, ChipUsage]:
        return {}


class DeviceMetrics:
    """Registers and refreshes the device gauge families."""

    def __init__(self, usage_reader: "UsageReader | None" = None, *,
                 registry: Registry) -> None:
        self._usage_reader = usage_reader or NullUsageReader()
        self._registry = registry
        self._usage_chips: set[int] = set()  # GPUs with live usage series
        # update_usage may run on executor threads; serialize reads so
        # concurrent scrapes cannot interleave a stale reading over a
        # fresh zeroing
        self._usage_lock = threading.Lock()
        self.build_info = Gauge(PREFIX + "build_info", "Build information",
                                labelnames=("version",), registry=registry)
        self.build_info.labels(version=VERSION).set(1)
        self.chips = Gauge(
            PREFIX + "chips", "Advertised devices per resource and health state",
            labelnames=("resource", "state"), registry=registry)
        self.hbm_total = Gauge(
            PREFIX + "chip_hbm_total_bytes", "Device memory per physical GPU",
            labelnames=("chip", "generation"), registry=registry)
        self.hbm_used = Gauge(
            PREFIX + "chip_hbm_used_bytes", "Device memory in use per physical GPU",
            labelnames=("chip",), registry=registry)
        self.duty_cycle = Gauge(
            PREFIX + "chip_duty_cycle_percent",
            "Share of NVML's sample period a kernel ran, per physical GPU",
            labelnames=("chip",), registry=registry)
        # 1 when the generation is a guess (no PCI id, no known model
        # name), 0 when measured, configured, or the fake backend's
        self.generation_guessed = Gauge(
            PREFIX + "generation_guessed",
            "1 if the GPU generation is a guess (not measured)",
            labelnames=("generation", "source"), registry=registry)

    def render(self, openmetrics: bool = False) -> str:
        return self._registry.render(openmetrics)

    def set_generation_source(self, generation: str, source: str) -> None:
        self.generation_guessed.labels(generation=generation, source=source).set(
            0 if source in ("pci", "name", "config", "fake") else 1)

    def update_inventory(self, chip_map: ChipMap) -> None:
        whole: dict[int, tuple[str, int]] = {}
        carved: dict[int, dict[str, tuple[str, int]]] = {}
        for resource, chips in chip_map.items():
            healthy = sum(1 for c in chips.values() if c.health == HEALTHY)
            unknown = sum(1 for c in chips.values() if c.health == UNKNOWN)
            self.chips.labels(resource=resource, state="healthy").set(healthy)
            self.chips.labels(resource=resource, state="unknown").set(unknown)
            self.chips.labels(resource=resource, state="unhealthy").set(
                len(chips) - healthy - unknown)
            for chip in chips.values():
                if chip.is_slice:
                    # a GPU's MIG instances: their memory adds up, each
                    # instance once however many replicas share it
                    physical = (AnnotatedID.parse(chip.id).device_id
                                if AnnotatedID.is_annotated(chip.id) else chip.id)
                    for idx in chip.chip_indices:
                        carved.setdefault(idx, {})[physical] = (
                            chip.generation, chip.total_memory)
                    continue
                for idx in chip.chip_indices:
                    whole[idx] = (chip.generation, chip.total_memory)
        for idx, parts in carved.items():
            whole[idx] = (next(iter(parts.values()))[0],
                          sum(mem for _, mem in parts.values()))
        for idx, (gen, mem) in whole.items():
            self.hbm_total.labels(chip=str(idx), generation=gen).set(mem)

    def update_usage(self) -> None:
        with self._usage_lock:
            self._update_usage_locked()

    def _update_usage_locked(self) -> None:
        reading = self._usage_reader.read()
        for idx, usage in reading.items():
            self.hbm_used.labels(chip=str(idx)).set(usage.hbm_used_bytes)
            self.duty_cycle.labels(chip=str(idx)).set(usage.duty_cycle_percent)
        # Workload gone (or no longer holding a GPU) -> that GPU is idle:
        # zero its gauges rather than exporting the last reading forever.
        for idx in self._usage_chips - set(reading):
            self.hbm_used.labels(chip=str(idx)).set(0)
            self.duty_cycle.labels(chip=str(idx)).set(0)
        self._usage_chips = set(reading)
