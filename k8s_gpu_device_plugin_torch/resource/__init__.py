"""Resource naming and partition strategy (port of the reference's
``resource/``): ``nvidia.com/gpu`` and ``nvidia.com/mig-<profile>``."""

from k8s_gpu_device_plugin_torch.resource.naming import (
    DEFAULT_RESOURCE,
    MAX_RESOURCE_NAME_LENGTH,
    RESOURCE_PREFIX,
    SHARED_SUFFIX,
    SLICE_STRATEGY_MIXED,
    SLICE_STRATEGY_NONE,
    SLICE_STRATEGY_SINGLE,
    Resource,
    ResourceName,
    ResourcePattern,
)
from k8s_gpu_device_plugin_torch.resource.resources import discover_resources

__all__ = [
    "Resource",
    "ResourceName",
    "ResourcePattern",
    "DEFAULT_RESOURCE",
    "RESOURCE_PREFIX",
    "SHARED_SUFFIX",
    "MAX_RESOURCE_NAME_LENGTH",
    "SLICE_STRATEGY_NONE",
    "SLICE_STRATEGY_SINGLE",
    "SLICE_STRATEGY_MIXED",
    "discover_resources",
]
