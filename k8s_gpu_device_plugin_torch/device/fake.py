"""Fake GPU backend: hosts as data.

Port of the reference's ``device/fake.py``: the whole control plane runs
with no GPU. The fake models any ``h100-N`` host, with an optional MIG
layout per GPU (profile names, placed at the start slots the MIG table
allows, device/slices.py), synthesizes stable UUIDs (``GPU-…`` for GPUs,
``MIG-…`` for instances) and device nodes (``/dev/nvidia<i>``, and the
capability nodes ``mig-minors`` would give an instance), and lets tests
flip a GPU's health. MIG layouts live on the fake only: nothing in the
port creates a MIG instance on a card.
"""

from __future__ import annotations

import hashlib
from typing import Mapping, Sequence

from k8s_gpu_device_plugin_torch.device.backend import ChipSpec, MigSpec
from k8s_gpu_device_plugin_torch.device.slices import (
    MEMORY_SLICES,
    SliceProfile,
    mig_minor,
    mig_paths,
    pack_gpu,
)
from k8s_gpu_device_plugin_torch.device.topology import HostTopology, parse_topology


def _stable_uuid(prefix: str, seed: str) -> str:
    h = hashlib.sha256(seed.encode()).hexdigest()
    return f"{prefix}-{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:32]}"


class FakeBackend:
    """In-memory backend over a synthetic host."""

    name = "fake"

    def __init__(
        self,
        topology: "str | HostTopology" = "h100-8",
        host_id: str = "fakehost",
        numa_nodes: int = 2,
        mig: "Mapping[int, Sequence[str]] | None" = None,
    ) -> None:
        self._topo = (
            topology if isinstance(topology, HostTopology) else parse_topology(topology)
        )
        self._host_id = host_id
        self._numa_nodes = max(1, numa_nodes)
        self._unhealthy: set[int] = set()
        self._mig: dict[int, list[tuple[SliceProfile, int]]] = {}
        for gpu, names in (mig or {}).items():
            if not 0 <= gpu < self._topo.num_chips:
                raise ValueError(f"MIG layout for GPU {gpu} of {self._topo.num_chips}")
            profiles = [SliceProfile.parse(n) for n in names]
            starts = pack_gpu(tuple(p.name for p in profiles))
            if starts is None:
                raise ValueError(f"MIG layout {list(names)} does not fit GPU {gpu}")
            self._mig[gpu] = list(zip(profiles, starts))

    def host_topology(self) -> HostTopology:
        return self._topo

    def enumerate_chips(self) -> list[ChipSpec]:
        gen = self._topo.generation
        chips = []
        coords = self._topo.coords()
        half = (len(coords) + 1) // 2
        for index, coord in enumerate(coords):
            chips.append(
                ChipSpec(
                    index=index,
                    uuid=_stable_uuid("GPU", f"{self._host_id}/{gen.name}/{index}"),
                    paths=(f"/dev/nvidia{index}",),
                    coord=coord,
                    numa_node=0 if index < half else self._numa_nodes - 1,
                    hbm_bytes=gen.hbm_bytes,
                    generation=gen.name,
                    name=gen.device_name,
                    pci_device_id=gen.pci_device_id,
                    mig_enabled=index in self._mig,
                )
            )
        return chips

    def enumerate_mig(self) -> list[MigSpec]:
        gen = self._topo.generation
        out = []
        for gpu in sorted(self._mig):
            # GPU instance ids in start-slot order, one compute instance each
            placed = sorted(self._mig[gpu], key=lambda ps: ps[1])
            for gi, (profile, start) in enumerate(placed, start=1):
                out.append(MigSpec(
                    parent_index=gpu,
                    uuid=_stable_uuid(
                        "MIG", f"{self._host_id}/{gen.name}/{gpu}/{gi}"),
                    profile=profile.name,
                    gi=gi,
                    ci=0,
                    paths=mig_paths(gpu, mig_minor(gpu, gi), mig_minor(gpu, gi, 0)),
                    hbm_bytes=gen.hbm_bytes * profile.size // MEMORY_SLICES,
                    start=start,
                ))
        return out

    def check_health(self) -> dict[int, bool]:
        return {i: i not in self._unhealthy for i in range(self._topo.num_chips)}

    # --- test hooks ---

    def set_unhealthy(self, *indices: int) -> None:
        self._unhealthy.update(indices)

    def set_healthy(self, *indices: int) -> None:
        self._unhealthy.difference_update(indices)
