"""Resource naming rules and MIG strategies.

Port of the reference's ``resource/naming.py`` with the Go original's
names back: the prefix is ``nvidia.com``, the whole-GPU resource
``nvidia.com/gpu``, and a MIG profile's resource ``nvidia.com/mig-<profile>``
(``nvidia.com/mig-1g.10gb``). The strategies keep their names:

- ``none``   — whole GPUs only, one resource;
- ``single`` — every GPU carved into one uniform MIG profile, advertised
               under the plain name;
- ``mixed``  — one resource per MIG profile.

The 63-character limit, the ``.shared`` suffix and the fnmatch patterns
are the reference's.
"""

from __future__ import annotations

import fnmatch
import re
from dataclasses import dataclass

RESOURCE_PREFIX = "nvidia.com"
DEFAULT_RESOURCE = "gpu"
SHARED_SUFFIX = ".shared"
MAX_RESOURCE_NAME_LENGTH = 63

SLICE_STRATEGY_NONE = "none"      # whole GPUs only, one resource
SLICE_STRATEGY_SINGLE = "single"  # one uniform MIG profile, one resource
SLICE_STRATEGY_MIXED = "mixed"    # one resource per MIG profile


class ResourceName(str):
    """A fully-qualified extended-resource name, e.g. ``nvidia.com/gpu``."""

    def split_name(self) -> tuple[str, str]:
        """Split into (prefix, base). Named ``split_name`` so the inherited
        ``str.split`` keeps working on ResourceName values."""
        if "/" in self:
            prefix, _, base = self.partition("/")
            return prefix, base
        return "", str(self)

    @property
    def is_shared(self) -> bool:
        return self.endswith(SHARED_SUFFIX)

    def shared(self) -> "ResourceName":
        if self.is_shared:
            return self
        return ResourceName(str(self) + SHARED_SUFFIX)

    def validate(self) -> None:
        if len(self) > MAX_RESOURCE_NAME_LENGTH:
            raise ValueError(
                f"resource name {self!r} exceeds {MAX_RESOURCE_NAME_LENGTH} chars"
            )
        prefix, base = self.split_name()
        if not prefix or not base:
            raise ValueError(f"resource name {self!r} must be <prefix>/<name>")


class ResourcePattern(str):
    """A shell wildcard matched against generation or MIG profile names."""

    def matches(self, name: str) -> bool:
        return re.fullmatch(fnmatch.translate(str(self)), name) is not None


@dataclass(frozen=True)
class Resource:
    """A (pattern -> resource name) pairing."""

    pattern: ResourcePattern
    name: ResourceName

    @staticmethod
    def new(pattern: str, name: str) -> "Resource":
        """Auto-prefix bare names with ``nvidia.com/``."""
        if "/" not in name:
            name = f"{RESOURCE_PREFIX}/{name}"
        resource = Resource(ResourcePattern(pattern), ResourceName(name))
        resource.name.validate()
        return resource
