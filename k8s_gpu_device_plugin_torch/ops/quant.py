"""Symmetric quantization to integer codes, and the port's int4 storage.

Port of ``k8s_gpu_device_plugin_tpu/ops/quant.py``'s
``_quantize_symmetric``, ``quantize_int8``, ``quantize_int4_sym`` (the
KV cache's per-row recipes, ``models/generate.py::_quantize_kv``) and
``quantize_int4_grouped`` (the int4 weight recipe,
``models/quantized_serving.py``). The same f32 input gives the
reference's codes and the reference's scale bits. ``int8_matmul`` is not
ported yet (ROADMAP A8).

int4 storage. ``jnp.int4`` is a narrow dtype XLA packs for itself; torch
has none, so the port defines the packing once, here: int4 codes are
stored as ``torch.uint8``, two codes per byte along the LAST axis. Byte
``j`` holds code ``2j`` in its low nibble and code ``2j + 1`` in its high
nibble, each nibble two's complement in [-8, 7]. A cache ``(..., hd)`` of
codes is stored as ``(..., hd / 2)`` bytes, a weight ``(..., K, N)`` as
``(..., K, N / 2)``. ``uint8`` means packed int4 codes everywhere in the
port. The recipes return the codes unpacked, as int8; :func:`pack_int4`
and :func:`unpack_int4` convert, exactly.

:func:`dot_f32` is the f32-accumulating product (the reference's
``preferred_element_type=f32``) the float and quantized lm_heads share.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _quantize_symmetric(x: torch.Tensor, axis: int, qmax: int,
                        dtype: torch.dtype, qmin: "int | None" = None,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """amax over ``axis`` in f32 -> floor at ``_EPS`` -> ``/ qmax`` ->
    round half to even -> clip to [``qmin`` (default -qmax), qmax].
    Returns (codes in ``dtype``, f32 scales with ``axis`` kept at 1)."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=_EPS) / qmax
    lo = -qmax if qmin is None else qmin
    q = torch.clamp(torch.round(xf / scale), lo, qmax).to(dtype)
    return q, scale


def quantize_int8(x: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``axis``; returns (q, scale)."""
    return _quantize_symmetric(x, axis, 127, torch.int8)


def quantize_int4_sym(x: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int4 quantization along ``axis`` (codes in [-7, 7], the
    -8 code dropped for symmetry as int8 drops -128); returns (int8
    codes, unpacked, and f32 scales). The per-row KV cache recipe."""
    return _quantize_symmetric(x, axis, 7, torch.int8)


def quantize_int4_grouped(x: torch.Tensor, group: int = 128,
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric int4 along the contraction axis (-2): ``x``
    (..., K, N) -> (int8 codes (..., K, N), unpacked, in [-8, 7]; f32
    scales (..., K // group, N)), one scale per ``group`` input channels
    per output channel (``scale = amax / 7``)."""
    *lead, k, n = x.shape
    if k % group:
        raise ValueError(f"contraction dim {k} not divisible by group {group}")
    xg = x.reshape(*lead, k // group, group, n)
    q, scale = _quantize_symmetric(xg, -2, 7, torch.int8, qmin=-8)
    return q.reshape(*lead, k, n), scale.squeeze(-2)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7], (..., 2n) -> uint8 (..., n): code 2j in the
    low nibble of byte j, code 2j + 1 in its high nibble."""
    if codes.dtype != torch.int8 or codes.shape[-1] % 2:
        raise ValueError(
            f"pack_int4 takes int8 codes with an even last axis, got "
            f"{codes.dtype} {tuple(codes.shape)}"
        )
    u = codes.view(torch.uint8)
    return (u[..., 0::2] & 0x0F) | ((u[..., 1::2] & 0x0F) << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (..., n) -> int8 codes (..., 2n), exactly: arithmetic shifts
    of the signed byte sign-extend each nibble."""
    if packed.dtype != torch.uint8:
        raise ValueError(f"unpack_int4 takes uint8, got {packed.dtype}")
    b = packed.view(torch.int8)
    codes = torch.stack(((b << 4) >> 4, b >> 4), dim=-1)
    return codes.reshape(*packed.shape[:-1], 2 * packed.shape[-1])


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) x (K, N) -> f32 from ``x.dtype`` operands with f32
    accumulation (the reference's ``preferred_element_type=f32``). On
    the card one cuBLAS GEMM writes f32 directly; the CPU has no such
    mixed-output GEMM, so it widens the operands (exact bf16->f32) and
    multiplies in f32: the same products and sums."""
    w = w.to(x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        out = x2 @ w
    elif x.device.type == "cuda":
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*lead, w.shape[-1])
