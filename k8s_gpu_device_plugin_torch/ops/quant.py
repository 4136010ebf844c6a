"""Symmetric quantization to integer codes, and the port's int4 storage.

Port of ``k8s_gpu_device_plugin_tpu/ops/quant.py``'s
``_quantize_symmetric``, ``quantize_int8``, ``quantize_int4_sym`` (the
KV cache's per-row recipes, ``models/generate.py::_quantize_kv``) and
``quantize_int4_grouped`` (the int4 weight recipe,
``models/quantized_serving.py``). The same f32 input gives the
reference's codes and the reference's scale bits.

Training's int8 products (the reference's ``int8_matmul`` and
``int8_expert_matmul``, an opt-in recipe: ``LlamaConfig(quant="int8")``):
a forward of int8 codes (x per row over K, w per column over K; the
expert form per expert) multiplied into int32 and rescaled in f32, and
the straight-through bf16 backward against the unquantized operands
(:func:`bf16_ste_bwd`, which the float lm_head's backward shares). The
int32 product is ``torch._int_mm`` on the card (cuBLASLt's int8 GEMM,
where the reference leaves the int8 dot to XLA; no hand-written kernel
yet) and an exact integer product on the CPU. Both entries are
``torch.library`` custom ops, so the selective-checkpoint policy of
``models/llama.py`` can save their outputs as the reference's policy
saves its ``"quant_dot"`` names: the backward re-runs no quantization and
no int8 product.

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

from k8s_gpu_device_plugin_torch.ops import kernel_support

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


def matmul_f32_acc(a: torch.Tensor, b: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """a @ b from ``a.dtype`` operands with f32 accumulation, rounded once
    to ``out_dtype``. cuBLAS accumulates bf16 products in f32 and rounds
    at the output; the CPU widens the operands (exact bf16 -> f32)."""
    if a.dtype == torch.float32 or a.device.type == "cuda":
        return (a @ b).to(out_dtype)
    return (a.float() @ b.float()).to(out_dtype)


def bf16_ste_bwd(x: torch.Tensor, w: torch.Tensor,
                 g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The shared straight-through backward of ``x (..., K) @ w (K, N)``:
    the cotangent cast to x's dtype, then dx and dw as f32-accumulated
    products against the unquantized operands, rounded to x's and w's
    dtypes (the reference's ``bf16_ste_bwd``)."""
    gb = g.to(x.dtype)
    dx = matmul_f32_acc(gb, w.to(x.dtype).T, x.dtype)
    k = x.shape[-1]
    dw = matmul_f32_acc(x.reshape(-1, k).T, gb.reshape(-1, gb.shape[-1]),
                        w.dtype)
    return dx, dw


# --- int8 training products -------------------------------------------------

#: launch count of the int8 product on the card (one a ``torch._int_mm``)
INT8_NAME = "int8_matmul"


def int8_mm_refusal(m: int, k: int, n: int) -> "str | None":
    """Why ``torch._int_mm`` cannot take an (m, k) x (k, n) product on the
    card, or None: m > 16, k and n positive multiples of 8."""
    if m <= 16:
        return f"int8 product rows M={m} must exceed 16"
    if k < 8 or k % 8 or n < 8 or n % 8:
        return f"int8 product K={k} and N={n} must be multiples of 8"
    return None


def _int_product(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32 (M, N), exactly. The card runs
    ``torch._int_mm`` on w's codes laid out (N, K) (the int8 GEMM's
    fast layout), counted as one launch; the CPU multiplies in float64,
    exact while K * 127^2 < 2^53."""
    m, k = qx.shape
    n = qw.shape[1]
    if qx.device.type == "cpu":
        return (qx.double() @ qw.double()).to(torch.int32)
    why = int8_mm_refusal(m, k, n)
    if why is not None:
        raise ValueError(f"int8_matmul on the card: {why}")
    y = torch._int_mm(qx.contiguous(), qw.t().contiguous().t())
    kernel_support.count_launch(INT8_NAME)
    return y


@torch.library.custom_op("k8s_gpu_device_plugin_torch::int8_matmul",
                         mutates_args=())
def int8_matmul_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` through int8 codes, in x's dtype."""
    qx, sx = quantize_int8(x, axis=-1)
    qw, sw = quantize_int8(w, axis=0)
    lead = x.shape[:-1]
    y = _int_product(qx.reshape(-1, x.shape[-1]), qw)
    y = y.reshape(*lead, w.shape[1])
    return (y.float() * sx * sw).to(x.dtype)


@int8_matmul_op.register_fake
def _(x, w):
    return x.new_empty((*x.shape[:-1], w.shape[1]))


def _int8_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _int8_backward(ctx, g):
    return bf16_ste_bwd(*ctx.saved_tensors, g)


int8_matmul_op.register_autograd(_int8_backward, setup_context=_int8_setup)


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with int8 operands; output in x's dtype. x: (..., K)
    activations, quantized per row over K; w: (K, N) weights, quantized
    per column over K. Rescaled as the reference does, ``(y * sx) * sw``
    in f32; the backward is :func:`bf16_ste_bwd`."""
    return int8_matmul_op(x, w.to(x.dtype))


@torch.library.custom_op("k8s_gpu_device_plugin_torch::int8_expert_matmul",
                         mutates_args=())
def int8_expert_matmul_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, M, D) x (E, D, F) -> (E, M, F) through int8 codes, one int32
    product an expert."""
    qx, sx = quantize_int8(x, axis=-1)
    qw, sw = quantize_int8(w, axis=1)
    y = torch.stack([_int_product(qx[e], qw[e]) for e in range(x.shape[0])])
    return (y.float() * sx * sw).to(x.dtype)


@int8_expert_matmul_op.register_fake
def _(x, w):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


def _int8_expert_backward(ctx, g):
    """The straight-through backward batched over E: dx = g w^T, dw =
    x^T g, f32 accumulation, rounded to x's and w's dtypes."""
    x, w = ctx.saved_tensors
    gb = g.to(x.dtype)
    dx = matmul_f32_acc(gb, w.transpose(1, 2), x.dtype)
    dw = matmul_f32_acc(x.transpose(1, 2), gb, w.dtype)
    return dx, dw


int8_expert_matmul_op.register_autograd(_int8_expert_backward,
                                        setup_context=_int8_setup)


def int8_expert_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The MoE expert product ``einsum('emd,edf->emf')`` with int8
    operands: scales per (e, m) row of x and per (e, f) column of w, so
    each expert quantizes on its own; backward straight-through in bf16,
    batched over E."""
    return int8_expert_matmul_op(x, w.to(x.dtype))
