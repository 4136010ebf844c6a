"""GPU generations and the host topology model.

Port of the reference's ``device/topology.py``. The reference's TPU
generations carry an ICI mesh: chips have 2-D or 3-D coordinates and
allocation quality is counted in contiguous sub-meshes. A GPU host is
one-dimensional: ``parse_topology("h100-8")`` gives bounds ``(8,)`` and
coordinates ``(i,)`` in the enumerator's order (PCI bus id), with no
wraparound. On an HGX board an NVSwitch links every pair of GPUs, so
index adjacency (``neighbors``) means nothing there; on a PCIe board
distance goes by NUMA node, then PCIe switch. What distance means is the
allocator's to decide; the mesh arithmetic (``coords``, ``index_of``,
``neighbors``, ``_factorize``, ``as_slice_member``, ``host_grid``,
``worker_index``) is ported as it is, so that the parity tests can hold
it to the reference's on the same 1-D bounds.

:data:`GENERATIONS` holds the cards the port knows. Their spec-sheet
peaks are the ones the live roofline prices at (``metrics/roofline.py``
reads them from here). No TPU row is carried over: the port runs on no
TPU.
"""

from __future__ import annotations

import itertools
import math
import re
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class GpuGeneration:
    """Static per-generation hardware description (≙ compute capability)."""

    name: str
    device_name: str             # CUDA's / NVML's name of the card
    pci_device_id: int           # vendor 0x10de's device id
    hbm_bytes: int
    peak_bf16_tflops: float      # per GPU, dense
    hbm_bandwidth_gbps: float    # per GPU


_GB = 1024**3

#: The H100 SXM5 80 GB: PCI id 0x2330 (``native/gpuenum.cc`` reads it),
#: 80 GB of HBM3, 989.4 TFLOP/s dense bf16 and 3352 GB/s at 700 W
#: (NVIDIA's data sheet). ``metrics/roofline.py`` prices at these peaks.
GENERATIONS: dict[str, GpuGeneration] = {
    "h100": GpuGeneration("h100", "NVIDIA H100 80GB HBM3", 0x2330, 80 * _GB,
                          989.4, 3352.0),
}


def _factorize(n: int, dims: int) -> tuple[int, ...]:
    """Near-square factorization of ``n`` into ``dims`` factors, descending."""
    best: tuple[int, ...] | None = None
    best_score = math.inf

    def candidates(remaining: int, slots: int):
        if slots == 1:
            yield (remaining,)
            return
        for d in range(1, remaining + 1):
            if remaining % d == 0:
                for rest in candidates(remaining // d, slots - 1):
                    yield (d, *rest)

    for combo in candidates(n, dims):
        score = max(combo) - min(combo)
        if score < best_score:
            best_score, best = score, tuple(sorted(combo, reverse=True))
    assert best is not None
    return best


@dataclass(frozen=True)
class HostTopology:
    """The GPUs of one host, as a segment of a (possibly multi-host) group.

    ``bounds`` is the host-local shape, ``(n_gpus,)``;
    ``slice_bounds``/``host_offset`` place the host inside a larger group
    for multi-host scheduling.
    """

    generation: GpuGeneration
    bounds: tuple[int, ...]
    slice_bounds: tuple[int, ...] | None = None
    host_offset: tuple[int, ...] = ()
    wraparound: tuple[bool, ...] = ()

    @property
    def num_chips(self) -> int:
        return math.prod(self.bounds)

    @property
    def is_multihost(self) -> bool:
        return self.slice_bounds is not None and self.slice_bounds != self.bounds

    @property
    def host_grid(self) -> tuple[int, ...]:
        """How many hosts tile the group along each axis."""
        if self.slice_bounds is None:
            return tuple(1 for _ in self.bounds)
        return tuple(s // b for s, b in zip(self.slice_bounds, self.bounds))

    @property
    def num_hosts(self) -> int:
        return math.prod(self.host_grid)

    @property
    def worker_index(self) -> int:
        """This host's rank in the group (row-major over ``host_grid``)."""
        if self.slice_bounds is None or not self.host_offset:
            return 0
        idx = 0
        for off, b, g in zip(self.host_offset, self.bounds, self.host_grid):
            idx = idx * g + off // b
        return idx

    def coords(self) -> list[tuple[int, ...]]:
        """Host-local GPU coordinates in index order (row-major)."""
        return list(itertools.product(*(range(b) for b in self.bounds)))

    def index_of(self, coord: tuple[int, ...]) -> int:
        idx = 0
        for c, b in zip(coord, self.bounds):
            idx = idx * b + c
        return idx

    def global_coord(self, coord: tuple[int, ...]) -> tuple[int, ...]:
        if not self.host_offset:
            return coord
        return tuple(o + c for o, c in zip(self.host_offset, coord))

    def neighbors(self, coord: tuple[int, ...]) -> list[tuple[int, ...]]:
        """Index neighbors of ``coord`` within host bounds (the reference's
        torus-aware rule; a GPU host never wraps)."""
        wrap = self.wraparound or tuple(False for _ in self.bounds)
        out = []
        for axis, bound in enumerate(self.bounds):
            for delta in (-1, 1):
                n = list(coord)
                n[axis] += delta
                if 0 <= n[axis] < bound:
                    out.append(tuple(n))
                elif wrap[axis] and bound > 2:
                    n[axis] %= bound
                    out.append(tuple(n))
        return out


def as_slice_member(
    host: HostTopology, slice_spec: str, worker_id: int
) -> HostTopology:
    """Place a host's GPUs inside a multi-host group.

    ``slice_spec`` names the FULL group (``h100-32`` = 4 hosts of 8 GPUs);
    ``worker_id`` is this host's rank. The group must tile evenly by
    ``host.bounds``; hosts are ranked row-major over the host grid, the
    convention ``worker_index`` inverts.
    """
    full = parse_topology(slice_spec)
    if full.generation.name != host.generation.name:
        raise ValueError(
            f"slice generation {full.generation.name} != host {host.generation.name}"
        )
    slice_bounds = full.bounds
    if len(slice_bounds) != len(host.bounds):
        raise ValueError(
            f"slice shape {slice_bounds} and host shape {host.bounds} differ in rank"
        )
    if any(s % b != 0 for s, b in zip(slice_bounds, host.bounds)):
        raise ValueError(
            f"slice {slice_bounds} does not tile evenly by host {host.bounds}"
        )
    grid = tuple(s // b for s, b in zip(slice_bounds, host.bounds))
    placed = HostTopology(
        generation=host.generation,
        bounds=host.bounds,
        slice_bounds=slice_bounds,
        host_offset=tuple(0 for _ in host.bounds),
        wraparound=tuple(w and g == 1 for w, g in zip(full.wraparound, grid)),
    )
    if not 0 <= worker_id < placed.num_hosts:
        raise ValueError(
            f"workerId {worker_id} out of range for {placed.num_hosts} hosts"
        )
    # row-major unravel of worker_id over the host grid (the inverse of
    # HostTopology.worker_index)
    offset = []
    rem = worker_id
    for g in reversed(grid):
        offset.append(rem % g)
        rem //= g
    offset = tuple(o * b for o, b in zip(reversed(offset), host.bounds))
    return replace(placed, host_offset=offset)


#: normalized CUDA device names (lowercase alphanumerics) -> GENERATIONS key
_DEVICE_NAMES = {
    re.sub(r"[^a-z0-9]", "", g.device_name.lower()): key
    for key, g in GENERATIONS.items()
}


def generation_for_device_kind(kind: str) -> str | None:
    """Map a CUDA device name (``torch.cuda.get_device_name``, NVML's
    name: ``"NVIDIA H100 80GB HBM3"``) or a generation key to a
    GENERATIONS key; None for a card the table does not hold (an H100
    PCIe or NVL has other peaks, and is not priced as the SXM part)."""
    k = re.sub(r"[^a-z0-9]", "", kind.lower())
    if k in GENERATIONS:
        return k
    return _DEVICE_NAMES.get(k)


_TOPOLOGY_RE = re.compile(r"^([a-z]+\d+[a-z]*)-(\d+)$")


def parse_topology(spec: str) -> HostTopology:
    """Parse ``h100-8`` into a one-dimensional HostTopology of 8 GPUs."""
    m = _TOPOLOGY_RE.match(spec)
    if not m:
        raise ValueError(f"unrecognized topology spec {spec!r}; want e.g. 'h100-8'")
    gen_name, count_s = m.groups()
    gen = GENERATIONS.get(gen_name)
    if gen is None:
        raise ValueError(
            f"unknown GPU generation {gen_name!r} in {spec!r} "
            f"(known: {sorted(GENERATIONS)})"
        )
    count = int(count_s)
    if count < 1:
        raise ValueError(f"topology {spec!r} has no GPUs")
    shape = _factorize(count, 1)
    return HostTopology(generation=gen, bounds=shape, wraparound=(False,))
