"""MIG partitioning: the counterpart of the reference's ICI sub-slices.

The reference carves a TPU host's chip mesh into contiguous sub-meshes,
each advertised as one device. On a GPU the partition is MIG (the Go
original's ``device/mig.go``): a GPU's 7 compute slices and 8 memory
slices hold GPU instances of fixed profiles at fixed start slots. The
H100 80 GB's profiles and placements (NVIDIA's *MIG User Guide*; start
and size in memory slices):

==========  =======  ====  ==============
profile     compute  size  starts
==========  =======  ====  ==============
1g.10gb     1        1     0 1 2 3 4 5 6
1g.20gb     1        2     0 2 4 6
2g.20gb     2        2     0 2 4
3g.40gb     3        4     0 4
4g.40gb     4        4     0
7g.80gb     7        8     0
==========  =======  ====  ==============

Instances on one GPU must not share a memory slice, and their compute
slices add up to at most 7. The administrator creates them (``nvidia-smi
mig``); the device plugin only reads what exists, and nothing here
switches a GPU's MIG mode. The planning functions keep the reference's
contracts: the fake backend lays its instances out with them, and the
``mixed`` strategy names its resources from a plan.

An instance's device nodes come from ``/proc/driver/nvidia-caps/mig-minors``
(lines such as ``gpu0/gi1/access 12``):
``/dev/nvidia-caps/nvidia-cap<minor>`` for the GPU instance and for the
compute instance, beside the parent's ``/dev/nvidia<minor>``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from k8s_gpu_device_plugin_torch.device.topology import HostTopology

COMPUTE_SLICES = 7
MEMORY_SLICES = 8


@dataclass(frozen=True)
class SliceProfile:
    """A MIG profile (≙ the reference's sub-slice shape): its compute
    slices, its memory slices and the start slots it may take."""

    name: str
    compute: int
    size: int
    starts: tuple[int, ...]

    @staticmethod
    def parse(name: str) -> "SliceProfile":
        profile = H100_PROFILES.get(name.strip())
        if profile is None:
            raise ValueError(
                f"bad MIG profile {name!r}; want one of {sorted(H100_PROFILES)}")
        return profile


H100_PROFILES: dict[str, SliceProfile] = {
    p.name: p
    for p in (
        SliceProfile("1g.10gb", 1, 1, (0, 1, 2, 3, 4, 5, 6)),
        SliceProfile("1g.20gb", 1, 2, (0, 2, 4, 6)),
        SliceProfile("2g.20gb", 2, 2, (0, 2, 4)),
        SliceProfile("3g.40gb", 3, 4, (0, 4)),
        SliceProfile("4g.40gb", 4, 4, (0,)),
        SliceProfile("7g.80gb", 7, 8, (0,)),
    )
}


@dataclass(frozen=True)
class SlicePlacement:
    """A MIG instance's place: its GPU and its first memory slice."""

    profile: SliceProfile
    gpu: int
    start: int

    @property
    def name(self) -> str:
        return f"{self.profile.name}@{self.gpu}:{self.start}"

    def slots(self) -> range:
        """The memory slices the instance holds."""
        return range(self.start, self.start + self.profile.size)

    def chip_indices(self, topo: HostTopology) -> list[int]:
        return [self.gpu]


def supported_profiles(topo: HostTopology) -> list[SliceProfile]:
    """The MIG profiles of the host's generation, smallest first."""
    if topo.generation.name != "h100":
        raise ValueError(f"no MIG profile table for {topo.generation.name}")
    return sorted(H100_PROFILES.values(), key=lambda p: (p.compute, p.size))


def enumerate_placements(topo: HostTopology,
                         profile: SliceProfile) -> list[SlicePlacement]:
    """Every placement of ``profile``: each GPU, each start slot."""
    supported_profiles(topo)
    return [SlicePlacement(profile, gpu, start)
            for gpu in range(topo.num_chips) for start in profile.starts]


def default_plan(topo: HostTopology) -> list[SliceProfile]:
    """Every GPU split in two halves (``3g.40gb`` at slots 0 and 4): the
    coarsest partitioning that is still a partitioning, as the
    reference's default splits a host into two half-host slices."""
    supported_profiles(topo)
    return [H100_PROFILES["3g.40gb"]] * (2 * topo.num_chips)


def uniform_plan(topo: HostTopology, profile: SliceProfile) -> list[SliceProfile]:
    """Every GPU carved into as many ``profile`` instances as one holds
    (strategy ``single``): 7 x 1g.10gb, 4 x 1g.20gb, 3 x 2g.20gb,
    2 x 3g.40gb, 1 x 4g.40gb or 1 x 7g.80gb."""
    supported_profiles(topo)
    per_gpu = max(n for n in range(1, len(profile.starts) + 1)
                  if pack_gpu((profile.name,) * n) is not None)
    return [profile] * (per_gpu * topo.num_chips)


def _order(name: str) -> tuple[int, int, str]:
    p = H100_PROFILES[name]
    return (-p.size, -p.compute, p.name)


@functools.lru_cache(maxsize=4096)
def pack_gpu(names: tuple[str, ...]) -> "tuple[int, ...] | None":
    """Start slots for instances of the profiles ``names`` on one GPU, in
    the order given, or None when they do not fit together. Exact: a
    depth-first search over the start slots, lowest slot first."""
    profiles = [SliceProfile.parse(n) for n in names]
    if (sum(p.compute for p in profiles) > COMPUTE_SLICES
            or sum(p.size for p in profiles) > MEMORY_SLICES):
        return None
    starts: list[int] = []

    def place(i: int, used: int) -> bool:
        if i == len(profiles):
            return True
        p = profiles[i]
        for s in p.starts:
            mask = ((1 << p.size) - 1) << s
            if used & mask:
                continue
            starts.append(s)
            if place(i + 1, used | mask):
                return True
            starts.pop()
        return False

    return tuple(starts) if place(0, 0) else None


def partition_host(topo: HostTopology,
                   plan: list[SliceProfile]) -> list[SlicePlacement]:
    """Place the MIG instances listed in ``plan`` on the host's GPUs.

    First fit across the GPUs, largest profiles first: each instance
    goes to the first GPU that can still hold it beside what that GPU
    holds, and the search backs up when a later instance fits nowhere,
    so every plan that fits packs. Raises if the plan does not fit.
    """
    supported_profiles(topo)
    names = sorted((SliceProfile.parse(p.name).name for p in plan), key=_order)
    n = topo.num_chips
    gpus: list[tuple[str, ...]] = [() for _ in range(n)]
    failed: set[tuple] = set()  # (next item, the GPUs' loads as a multiset)

    def assign(i: int) -> bool:
        if i == len(names):
            return True
        key = (i, tuple(sorted(gpus)))
        if key in failed:  # the GPUs are interchangeable
            return False
        tried: set[tuple[str, ...]] = set()
        for g in range(n):
            held = gpus[g]
            if held in tried:  # an equal GPU already failed this branch
                continue
            tried.add(held)
            grown = (*held, names[i])  # stays largest first
            if pack_gpu(grown) is None:
                continue
            gpus[g] = grown
            if assign(i + 1):
                return True
            gpus[g] = held
        failed.add(key)
        return False

    profiles = [H100_PROFILES[name] for name in names]
    if (sum(p.compute for p in profiles) > COMPUTE_SLICES * n
            or sum(p.size for p in profiles) > MEMORY_SLICES * n
            or not assign(0)):
        raise ValueError(
            f"MIG plan does not fit: {','.join(p.name for p in plan)} on "
            f"{n} GPU(s) of {COMPUTE_SLICES} compute and {MEMORY_SLICES} "
            "memory slices each")
    out = [SlicePlacement(H100_PROFILES[name], g, start)
           for g, held in enumerate(gpus)
           for name, start in zip(held, pack_gpu(held) or ())]
    return sorted(out, key=lambda p: (p.gpu, p.start))


# --- /proc/driver/nvidia-caps/mig-minors ---------------------------------


def mig_minor(gpu: int, gi: int, ci: int = -1) -> int:
    """The capability minor the driver's ``mig-minors`` lists for a GPU
    instance's ``access`` line (``ci`` -1) or a compute instance's
    (``config`` is 1, ``monitor`` 2, then per GPU minor 15 GPU instances
    of 9 lines: the instance's ``access`` and its 8 compute instances').
    The fake backend's paths."""
    base = 3 + gpu * 15 * 9 + gi * 9
    return base if ci < 0 else base + 1 + ci


def mig_paths(gpu_minor: int, gi_minor: int, ci_minor: int) -> tuple[str, ...]:
    """A MIG instance's device nodes."""
    return (f"/dev/nvidia{gpu_minor}",
            f"/dev/nvidia-caps/nvidia-cap{gi_minor}",
            f"/dev/nvidia-caps/nvidia-cap{ci_minor}")
