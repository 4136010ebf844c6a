"""Resource discovery per MIG strategy (port of the reference's
``resource/resources.py``).

``none``/``single`` emit ``nvidia.com/gpu`` with a match-all pattern
(devices are matched by generation name). ``mixed`` emits one resource per
MIG profile of the plan, ``nvidia.com/mig-<profile>``, and, when the
topology is known, ``nvidia.com/gpu`` for the generation's whole GPUs: the
Go original's mixed strategy advertises a GPU whose MIG mode is off under
the plain name.
"""

from __future__ import annotations

from k8s_gpu_device_plugin_torch.device.slices import SliceProfile, default_plan
from k8s_gpu_device_plugin_torch.device.topology import HostTopology
from k8s_gpu_device_plugin_torch.resource.naming import (
    DEFAULT_RESOURCE,
    SLICE_STRATEGY_MIXED,
    Resource,
)


def discover_resources(
    strategy: str,
    topology: HostTopology | None = None,
    slice_plan: str = "",
) -> list[Resource]:
    """Enumerate the extended resources this host will advertise.

    ``slice_plan`` lists MIG profiles (``"3g.40gb,1g.10gb"``); without one,
    mixed takes :func:`default_plan`'s profile.
    """
    if strategy != SLICE_STRATEGY_MIXED:
        return [Resource.new("*", DEFAULT_RESOURCE)]

    if slice_plan:
        profiles = [SliceProfile.parse(p) for p in slice_plan.split(",") if p.strip()]
    else:
        if topology is None:
            raise ValueError("mixed strategy needs a topology or explicit slicePlan")
        profiles = default_plan(topology)

    out: list[Resource] = []
    seen: set[str] = set()
    for profile in profiles:
        if profile.name in seen:
            continue
        seen.add(profile.name)
        out.append(Resource.new(profile.name, f"mig-{profile.name}"))
    if topology is not None:
        out.append(Resource.new(topology.generation.name, DEFAULT_RESOURCE))
    return out
