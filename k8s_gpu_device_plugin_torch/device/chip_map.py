"""ChipMap builder: resource name -> set of schedulable devices.

Port of the reference's ``device/chip_map.py``: strategy dispatch,
wildcard patterns matched against device names (a name no pattern
matches is a hard error), and ``shared_replicas`` as annotated IDs. The
strategies are the Go original's (``device/device_map.go``):

- ``none``   — every whole GPU is one device, matched by its generation
               name (``nvidia.com/gpu``), MIG mode or not.
- ``single`` — every GPU is in MIG mode with instances of one profile
               (``slice_shape``, when given, names it); each instance is
               one device under the plain name, matched by generation.
               A host with no GPU in MIG mode advertises whole GPUs.
- ``mixed``  — each MIG instance is one device matched by its profile
               (``nvidia.com/mig-<profile>``); a GPU whose MIG mode is off
               is a whole device matched by its generation.

Under ``single`` and ``mixed`` a GPU in MIG mode is advertised by its
instances only, none if it has none.

The reference carves its sub-slices here from a plan. MIG instances are
made by the administrator, so the port reads them from the backend
(``enumerate_mig``) and never creates one.
"""

from __future__ import annotations

from dataclasses import replace

from k8s_gpu_device_plugin_torch.device.backend import ChipBackend, ChipSpec, MigSpec
from k8s_gpu_device_plugin_torch.device.chip import AnnotatedID, Chip, Chips
from k8s_gpu_device_plugin_torch.device.slices import SliceProfile
from k8s_gpu_device_plugin_torch.resource.naming import (
    SLICE_STRATEGY_MIXED,
    SLICE_STRATEGY_NONE,
    SLICE_STRATEGY_SINGLE,
    Resource,
)


class ChipMap(dict[str, Chips]):
    """resource name -> Chips."""

    def total_devices(self) -> int:
        return sum(len(chips) for chips in self.values())


def _build_chip(spec: ChipSpec) -> Chip:
    """A whole GPU."""
    return Chip(
        id=spec.uuid,
        index=spec.index,
        paths=spec.paths,
        coords=(spec.coord,),
        generation=spec.generation,
        total_memory=spec.hbm_bytes,
        numa_node=spec.numa_node,
        chip_indices=(spec.index,),
    )


def _build_mig(mig: MigSpec, parent: ChipSpec, index: int) -> Chip:
    """One MIG instance on ``parent``."""
    return Chip(
        id=mig.uuid,
        index=index,
        paths=mig.paths,
        coords=(parent.coord,),
        generation=parent.generation,
        total_memory=mig.hbm_bytes,
        numa_node=parent.numa_node,
        slice_profile=mig.profile,
        chip_indices=(parent.index,),
    )


def _match_resource(name: str, resources: list[Resource]) -> Resource:
    """First pattern match wins; no match is a hard error."""
    for resource in resources:
        if resource.pattern.matches(name):
            return resource
    raise ValueError(
        f"no resource pattern matches device name {name!r} "
        f"(patterns: {[str(r.pattern) for r in resources]})"
    )


def new_chip_map(
    backend: ChipBackend,
    resources: list[Resource],
    strategy: str,
    slice_shape: str = "",
    shared_replicas: int = 0,
) -> ChipMap:
    """Build the ChipMap.

    ``shared_replicas`` > 0 advertises each device ``n`` times under
    annotated IDs for time-sliced sharing.
    """
    if strategy not in (SLICE_STRATEGY_NONE, SLICE_STRATEGY_SINGLE,
                        SLICE_STRATEGY_MIXED):
        raise ValueError(f"unknown slice strategy {strategy!r}")
    specs = backend.enumerate_chips()
    chip_map = ChipMap()

    def add(resource: Resource, chip: Chip) -> None:
        chips = chip_map.setdefault(str(resource.name), Chips())
        if shared_replicas > 0:
            for r in range(shared_replicas):
                rid = str(AnnotatedID(chip.id, r))
                chips[rid] = replace(chip, id=rid, replicas=shared_replicas)
        else:
            chips[chip.id] = chip

    if strategy == SLICE_STRATEGY_NONE:
        migs, in_mig = [], set()
    else:  # a GPU in MIG mode is advertised by its instances only
        migs = backend.enumerate_mig()
        in_mig = {s.index for s in specs if s.mig_enabled} | {
            m.parent_index for m in migs}
    if strategy == SLICE_STRATEGY_SINGLE:
        _check_single(specs, migs, in_mig, slice_shape)
    by_index = {s.index: s for s in specs}
    for spec in specs:
        if spec.index not in in_mig:
            add(_match_resource(spec.generation, resources), _build_chip(spec))
    for i, mig in enumerate(migs):
        chip = _build_mig(mig, by_index[mig.parent_index], i)
        name = chip.generation if strategy == SLICE_STRATEGY_SINGLE \
            else chip.slice_profile
        add(_match_resource(name, resources), chip)
    return chip_map


def _check_single(specs: list[ChipSpec], migs: list[MigSpec], in_mig: set,
                  slice_shape: str) -> None:
    """``single`` wants every GPU in MIG mode with one profile, or none."""
    if not in_mig and not slice_shape:
        return
    want = SliceProfile.parse(slice_shape).name if slice_shape else (
        migs[0].profile if migs else "")
    whole = [s.index for s in specs if s.index not in in_mig]
    other = sorted({m.profile for m in migs} - {want})
    if whole or other:
        raise ValueError(
            f"strategy single wants every GPU carved into {want} instances; "
            f"GPUs not in MIG mode: {whole}, other profiles: {other}")
