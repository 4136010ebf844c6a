"""Symmetric quantization to integer codes.

Port of ``k8s_gpu_device_plugin_tpu/ops/quant.py``'s
``_quantize_symmetric`` and ``quantize_int8``: the one recipe the KV
cache's int8 codes are made with (``models/generate.py::_quantize_kv``).
The same f32 input gives the reference's codes and the reference's scale
bits. ``int8_matmul`` and the int4 recipes are not ported yet.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _quantize_symmetric(x: torch.Tensor, axis: int, qmax: int,
                        dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """amax over ``axis`` in f32 -> floor at ``_EPS`` -> ``/ qmax`` ->
    round half to even -> clip to +-qmax. Returns (codes in ``dtype``,
    f32 scales with ``axis`` kept at 1)."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=_EPS) / qmax
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(dtype)
    return q, scale


def quantize_int8(x: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``axis``; returns (q, scale)."""
    return _quantize_symmetric(x, axis, 127, torch.int8)
