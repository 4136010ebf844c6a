"""Parallelism: mesh conventions and tensor-parallel serving.

Port of ``k8s_gpu_device_plugin_tpu/parallel/``, so far its mesh rule
(``mesh.py``) and its serving shardings (``tp_serving.py``). Sequence,
pipeline and data parallelism for training are ROADMAP A.13.
"""

from k8s_gpu_device_plugin_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_FSDP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    MeshSpec,
)

__all__ = ["AXIS_DP", "AXIS_FSDP", "AXIS_TP", "AXIS_SP", "AXIS_EP",
           "AXIS_PP", "MeshSpec"]
