"""Mesh axis names and the one mesh-flag rule.

Port of ``k8s_gpu_device_plugin_tpu/parallel/mesh.py``: the axis
vocabulary, the :class:`MeshSpec` dataclass and its ``for_devices`` /
``from_flags`` constructors, with the reference's messages word for word.

- ``dp``   pure data parallelism
- ``fsdp`` data parallelism with parameter sharding
- ``tp``   tensor (megatron-style) parallelism within attention/MLP blocks
- ``sp``   sequence/context parallelism for long sequences
- ``ep``   expert parallelism for MoE layers
- ``pp``   pipeline stages

The visible device count defaults to the CUDA cards this process sees
(``torch.cuda.device_count()``). Serving is the only user so far
(``parallel/tp_serving.py``); the training mesh and its batch sharding
(``make_mesh``, ``batch_spec``) come with ROADMAP A.13 and raise until
then.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_EP = "ep"
AXIS_PP = "pp"

# Outer-to-inner order: dp/pp outermost, fsdp next, tp/sp innermost (the
# fastest links)
AXIS_ORDER = (AXIS_DP, AXIS_PP, AXIS_FSDP, AXIS_EP, AXIS_SP, AXIS_TP)


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Axes of size 1 still exist."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.ep * self.pp

    def sizes(self) -> dict[str, int]:
        return {
            AXIS_DP: self.dp,
            AXIS_PP: self.pp,
            AXIS_FSDP: self.fsdp,
            AXIS_EP: self.ep,
            AXIS_SP: self.sp,
            AXIS_TP: self.tp,
        }

    @staticmethod
    def for_devices(
        n: int,
        tp: int = 1,
        sp: int = 1,
        ep: int = 1,
        pp: int = 1,
        fsdp: "int | None" = None,
    ) -> "MeshSpec":
        """Fill dp (or fsdp) with whatever ``n`` leaves over tp*sp*ep*pp."""
        inner = tp * sp * ep * pp
        if n % inner != 0:
            raise ValueError(f"{n} devices not divisible by tp*sp*ep*pp={inner}")
        rest = n // inner
        if fsdp is None:
            return MeshSpec(dp=rest, fsdp=1, tp=tp, sp=sp, ep=ep, pp=pp)
        if rest % fsdp != 0:
            raise ValueError(f"remainder {rest} not divisible by fsdp={fsdp}")
        return MeshSpec(dp=rest // fsdp, fsdp=fsdp, tp=tp, sp=sp, ep=ep, pp=pp)

    @staticmethod
    def from_flags(
        tp: int = 1,
        sp: int = 1,
        ep: int = 1,
        pp: int = 1,
        fsdp: "int | None" = None,
        n_devices: "int | None" = None,
        n_kv_heads: "int | None" = None,
        exact: bool = False,
    ) -> "MeshSpec":
        """The one mesh-construction/validation rule behind every CLI
        surface, so flag errors mean the same thing everywhere and fail
        at startup. ``n_devices`` defaults to the visible CUDA cards.
        ``exact=True`` is the serving shape: dp/fsdp stay 1 (the mesh
        spans exactly tp*sp*ep*pp devices; devices beyond it stay
        unused), and the divisibility check still applies. ``n_kv_heads``
        adds the serving KV-shard check: the cache shards on the KV-head
        axis, so tp must divide it."""
        if n_devices is None:
            n_devices = torch.cuda.device_count()
        inner = tp * sp * ep * pp
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if inner > n_devices:
            raise ValueError(
                f"mesh tp*sp*ep*pp={inner} needs {inner} devices but only "
                f"{n_devices} are visible; lower the axis sizes or "
                "allocate a larger slice"
            )
        if n_devices % inner != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by tp*sp*ep*pp="
                f"{inner}; pick axis sizes whose product divides the "
                "device count (a non-dividing size is almost always a "
                "mis-sized flag — fail at startup, not mid-trace)"
            )
        if n_kv_heads is not None and n_kv_heads % tp != 0:
            raise ValueError(
                f"tp={tp} does not divide n_kv_heads={n_kv_heads}: the "
                "serving KV cache shards on the KV-head axis, so every "
                "shard must hold a whole number of heads — pick a tp "
                f"from the divisors of {n_kv_heads}"
            )
        if exact:
            return MeshSpec(dp=1, fsdp=1, tp=tp, sp=sp, ep=ep, pp=pp)
        return MeshSpec.for_devices(
            n_devices, tp=tp, sp=sp, ep=ep, pp=pp, fsdp=fsdp
        )


def make_mesh(spec: MeshSpec, devices: "list | None" = None):
    """The training mesh: not ported yet."""
    raise NotImplementedError(
        "make_mesh builds the training mesh, which is not ported yet "
        "(ROADMAP A.13); serving builds its own (parallel/tp_serving.py "
        "serving_mesh)")


def batch_spec():
    """The training batch sharding: not ported yet."""
    raise NotImplementedError(
        "batch_spec shards training batches, which is not ported yet "
        "(ROADMAP A.13)")
