"""Chip (device) model and set operations.

Port of the reference's ``device/chip.py``, nearly verbatim. The
schedulable unit is a ``Chip``: one whole GPU (strategy ``none``) or one
MIG instance (strategies ``single``/``mixed``, see device/slices.py).
``generation`` plays the part of the compute capability; ``coords`` are
GPU indices, ``(i,)``; ``slice_profile`` is the MIG profile name, empty
for a whole GPU; ``chip_indices`` holds the parent GPU's index.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterable, Iterator

HEALTHY = "Healthy"      # pluginapi.Healthy
UNHEALTHY = "Unhealthy"  # pluginapi.Unhealthy
# Liveness evidence lost (usage readings went stale / the idle probe
# hung) without a confirmed fault. kubelet treats any non-"Healthy"
# string as unschedulable, so this withdraws the GPU while staying honest
# about what is actually known.
UNKNOWN = "Unknown"

ANNOTATION_SEP = "::"


@dataclass(frozen=True)
class AnnotatedID:
    """``<id>::<replica>`` device-ID scheme for shared devices."""

    device_id: str
    replica: int

    def __str__(self) -> str:
        return f"{self.device_id}{ANNOTATION_SEP}{self.replica}"

    @staticmethod
    def parse(s: str) -> "AnnotatedID":
        if not AnnotatedID.is_annotated(s):
            raise ValueError(f"{s!r} is not an annotated ID")
        device_id, _, replica = s.rpartition(ANNOTATION_SEP)
        return AnnotatedID(device_id, int(replica))

    @staticmethod
    def is_annotated(s: str) -> bool:
        head, sep, tail = s.rpartition(ANNOTATION_SEP)
        return bool(sep) and bool(head) and tail.isdigit()

    @staticmethod
    def any_annotated(ids: Iterable[str]) -> bool:
        return any(AnnotatedID.is_annotated(i) for i in ids)


@dataclass(frozen=True)
class Chip:
    """One schedulable GPU or MIG instance."""

    id: str                                  # GPU-… or MIG-… UUID
    index: int                               # enumeration index on the host
    paths: tuple[str, ...]                   # /dev/nvidia<minor> (+ MIG caps)
    coords: tuple[tuple[int, ...], ...]      # GPU index coords of members
    generation: str                          # ≙ ComputeCapability
    total_memory: int                        # device memory bytes
    numa_node: int = -1                      # host NUMA node, -1 = unknown
    health: str = HEALTHY
    replicas: int = 0                        # >0 => time-sliced shared device
    slice_profile: str = ""                  # "" for whole GPUs; "1g.10gb" for MIG
    chip_indices: tuple[int, ...] = ()       # parent GPU indices

    @property
    def is_slice(self) -> bool:
        return bool(self.slice_profile)

    @property
    def num_chips(self) -> int:
        return len(self.coords) or 1

    def with_health(self, health: str) -> "Chip":
        return replace(self, health=health)


class Chips(dict[str, Chip]):
    """Set of chips keyed by device ID."""

    @staticmethod
    def of(chips: Iterable[Chip]) -> "Chips":
        out = Chips()
        for chip in chips:
            out[chip.id] = chip
        return out

    # --- set operations ---

    def contains(self, *ids: str) -> bool:
        return all(i in self for i in ids)

    def get_by_id(self, chip_id: str) -> Chip | None:
        return self.get(chip_id)

    def get_by_index(self, index: int) -> Chip | None:
        for chip in self.values():
            if chip.index == index:
                return chip
        return None

    def subset(self, ids: Iterable[str]) -> "Chips":
        return Chips({i: self[i] for i in ids if i in self})

    def difference(self, other: "Chips") -> "Chips":
        return Chips({i: c for i, c in self.items() if i not in other})

    def ids(self) -> list[str]:
        return sorted(self.keys())

    def indices(self) -> list[int]:
        return sorted(c.index for c in self.values())

    def all_paths(self) -> list[str]:
        seen: dict[str, None] = {}
        for chip in sorted(self.values(), key=lambda c: c.index):
            for p in chip.paths:
                seen.setdefault(p, None)
        return list(seen)

    def healthy(self) -> "Chips":
        return Chips({i: c for i, c in self.items() if c.health == HEALTHY})

    def iter_sorted(self) -> Iterator[Chip]:
        return iter(sorted(self.values(), key=lambda c: c.index))

    # --- shared/replicated devices ---

    def physical_ids(self) -> list[str]:
        """Collapse annotated replicas to their physical device IDs."""
        out: dict[str, None] = {}
        for i in self.keys():
            if AnnotatedID.is_annotated(i):
                out.setdefault(AnnotatedID.parse(i).device_id, None)
            else:
                out.setdefault(i, None)
        return list(out)

    # --- allocation support ---

    def aligned_allocation_supported(self) -> bool:
        """Topology-aligned allocation needs whole GPUs with known coords
        (MIG instances are placed when the administrator creates them)."""
        return all(not c.is_slice and c.coords for c in self.values())
