"""Fused lm_head + cross-entropy: the (B, S, V) logits never exist.

Port of ``k8s_gpu_device_plugin_tpu/ops/fused_ce.py``. The reference is
not a TPU kernel: it scans (D, chunk) slices of the head with an online
logsumexp and lets XLA fuse each chunk's passes, under
``jax.checkpoint(nothing_saveable)`` so the backward recomputes each
chunk's logits. The port keeps that algorithm and its memory contract
(extra memory of one chunk of logits, forward or backward) with the chunk
products on cuBLAS and the passes over each chunk's f32 logits as
hand-written kernels (``csrc/fused_ce.cu``):

- K6 ``ce_chunk_fwd``: per row, folds the chunk's max and sum-exp into
  the running (m, s) and picks up the target logit when the chunk owns it;
- K7 ``ce_chunk_bwd``: ``dlogits = g/N ((1 + 2 z lse) softmax - onehot)``
  in the activations' dtype, in one pass over the recomputed logits.

Both are bound by bytes (a read of the chunk's f32 logits; K7 also writes
the cotangent). The forward saves x, w, targets and the f32 lse (N
floats); the backward recomputes each chunk's logits, accumulates
``dx += dlogits @ w_c^T`` in f32 across chunks (rounded once) and writes
``dw[:, c0:c1] = x^T @ dlogits``. Chunks are column slices of the head:
no padded transposed copy of it is made (the reference's ``jnp.pad(w.T)``
is 1.05 GB a step at Llama-3-8B widths); the last chunk of a vocabulary
the chunk does not divide is narrower, and the kernels take its width.

The wrappers launch the kernels for CUDA tensors and take the plain
versions (same arithmetic in PyTorch) only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from k8s_gpu_device_plugin_torch.ops import kernel_support
from k8s_gpu_device_plugin_torch.ops.quant import dot_f32, matmul_f32_acc

SOURCE = kernel_support.CSRC_DIR / "fused_ce.cu"

FWD_NAME = "ce_chunk_fwd"
BWD_NAME = "ce_chunk_bwd"

#: the z-loss weight of every loss path (``models/train.py``)
Z_LOSS_WEIGHT = 1e-4

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # logits, rows, width, targets, c0, m, s, tl, stream
    FWD_NAME: [_P, _L, _I, _P, _L, _P, _P, _P, _P],
    # logits, rows, width, targets, c0, lse, g, z, dtype, out, stream
    BWD_NAME: [_P, _L, _I, _P, _L, _P, _P, _F, _I, _P, _P],
}


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = kernel_support.load_library("fused_ce", [SOURCE])
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _pad_chunks(vocab: int, chunk: int) -> tuple[int, int]:
    """(n_chunks, padded_vocab) for a fixed chunk size, as the reference
    counts them: the last chunk is narrower rather than the chunk shrunk
    to a divisor (50257 = 29 x 1733 would be 1733 tiny chunks). The port
    pads nothing; ``padded_vocab`` is the columns the reference's scan
    covers."""
    chunk = min(chunk, vocab)
    n_chunks = -(-vocab // chunk)
    return n_chunks, n_chunks * chunk


def chunk_bounds(vocab: int, chunk: int) -> list[tuple[int, int]]:
    """The [c0, c1) column ranges of the chunks, the last one narrower."""
    chunk = min(chunk, vocab)
    return [(c0, min(c0 + chunk, vocab)) for c0 in range(0, vocab, chunk)]


# --- the plain versions ---------------------------------------------------------


def ce_chunk_fwd_reference(logits: torch.Tensor, targets: torch.Tensor,
                           c0: int, m: torch.Tensor, s: torch.Tensor,
                           tl: torch.Tensor) -> None:
    """K6's plain version: fold the chunk (N, width) f32 into the running
    max ``m`` and sum-exp ``s`` and pick the target logit into ``tl``, all
    (N,) f32, in place."""
    m_new = torch.maximum(m, logits.amax(dim=-1))
    s.copy_(s * torch.exp(m - m_new)
            + torch.exp(logits - m_new[:, None]).sum(dim=-1))
    m.copy_(m_new)
    idx = targets - c0
    owned = (idx >= 0) & (idx < logits.shape[1])
    picked = torch.gather(logits, 1, idx.clamp(0, logits.shape[1] - 1)[:, None])
    tl.copy_(torch.where(owned, picked[:, 0], tl))


def ce_chunk_bwd_reference(logits: torch.Tensor, targets: torch.Tensor,
                           c0: int, lse: torch.Tensor, g: torch.Tensor,
                           z: float, dtype: torch.dtype) -> torch.Tensor:
    """K7's plain version: ``(g / N) ((1 + 2 z lse) exp(l - lse) -
    onehot)`` for the chunk (N, width), in ``dtype``, in the kernel's
    order of operations (every scalar a tensor: no host-scalar shortcut)."""
    n, width = logits.shape
    g_n = g.float() / torch.tensor(float(n), device=g.device)
    coef = 1.0 + lse * (2.0 * z)
    d = coef[:, None] * torch.exp(logits - lse[:, None])
    idx = targets - c0
    rows = torch.nonzero((idx >= 0) & (idx < width))[:, 0]
    d[rows, idx[rows]] -= 1.0
    return (d * g_n).to(dtype)


# --- the kernels' wrappers ------------------------------------------------------


def _check_chunk(logits: torch.Tensor, targets: torch.Tensor,
                 *rows: torch.Tensor) -> None:
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"a chunk's logits are (N, width) f32, got "
                         f"{logits.dtype} {tuple(logits.shape)}")
    n = logits.shape[0]
    if targets.dtype != torch.int64 or tuple(targets.shape) != (n,):
        raise ValueError(f"targets must be int64 ({n},), got {targets.dtype} "
                         f"{tuple(targets.shape)}")
    for x in rows:
        if x.dtype != torch.float32 or tuple(x.shape) != (n,):
            raise ValueError(f"row values must be f32 ({n},), got {x.dtype} "
                             f"{tuple(x.shape)}")
    for x in (logits, targets, *rows):
        if x.device != logits.device:
            raise ValueError("the chunk's tensors lie on different devices")
        if logits.device.type == "cuda" and not x.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def _launch(name: str, x: torch.Tensor, *args) -> None:
    err = getattr(load_kernel(), name)(
        *args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    kernel_support.count_launch(name)


def ce_chunk_fwd(logits: torch.Tensor, targets: torch.Tensor, c0: int,
                 m: torch.Tensor, s: torch.Tensor, tl: torch.Tensor) -> None:
    """K6 on a CUDA tensor, :func:`ce_chunk_fwd_reference` on a CPU one."""
    _check_chunk(logits, targets, m, s, tl)
    if logits.device.type == "cpu":
        ce_chunk_fwd_reference(logits, targets, c0, m, s, tl)
        return
    _launch(FWD_NAME, logits, logits.data_ptr(), logits.shape[0],
            logits.shape[1], targets.data_ptr(), int(c0), m.data_ptr(),
            s.data_ptr(), tl.data_ptr())


def ce_chunk_bwd(logits: torch.Tensor, targets: torch.Tensor, c0: int,
                 lse: torch.Tensor, g: torch.Tensor, z: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """K7 on a CUDA tensor, :func:`ce_chunk_bwd_reference` on a CPU one;
    ``g`` is the loss's 0-d f32 cotangent, read on the device."""
    _check_chunk(logits, targets, lse)
    if dtype not in _DTYPES:
        raise ValueError(f"the cotangent is bf16 or f32, got {dtype}")
    if logits.device.type == "cpu":
        return ce_chunk_bwd_reference(logits, targets, c0, lse, g, z, dtype)
    g = g.float().contiguous()
    out = torch.empty(logits.shape, dtype=dtype, device=logits.device)
    _launch(BWD_NAME, logits, logits.data_ptr(), logits.shape[0],
            logits.shape[1], targets.data_ptr(), int(c0), lse.data_ptr(),
            g.data_ptr(), float(z), _DTYPES[dtype], out.data_ptr())
    return out


# --- the loss -------------------------------------------------------------------


class _FusedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, w, t, z, chunk):
        n = x2.shape[0]
        m = torch.full((n,), float("-inf"), dtype=torch.float32,
                       device=x2.device)
        s = torch.zeros((n,), dtype=torch.float32, device=x2.device)
        tl = torch.zeros((n,), dtype=torch.float32, device=x2.device)
        bounds = chunk_bounds(w.shape[1], chunk)
        for c0, c1 in bounds:
            ce_chunk_fwd(dot_f32(x2, w[:, c0:c1]), t, c0, m, s, tl)
        lse = m + torch.log(s)
        loss = ((lse - tl) + z * lse.square()).mean()
        ctx.save_for_backward(x2, w, t, lse)
        ctx.z, ctx.bounds = z, bounds
        return loss

    @staticmethod
    def backward(ctx, g):
        x2, w, t, lse = ctx.saved_tensors
        dx = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
        dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
        for c0, c1 in ctx.bounds:
            wc = w[:, c0:c1]
            dl = ce_chunk_bwd(dot_f32(x2, wc), t, c0, lse, g, ctx.z,
                              x2.dtype)
            dx += dot_f32(dl, wc.T)
            dw[:, c0:c1] = matmul_f32_acc(x2.T, dl, w.dtype)
        return dx.to(x2.dtype), dw, None, None, None


def fused_linear_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                               targets: torch.Tensor,
                               z_loss_weight: float = Z_LOSS_WEIGHT,
                               chunk: int = 4096) -> torch.Tensor:
    """Mean token cross-entropy (+ z-loss) of ``softmax(x @ w)`` against
    ``targets``: x (B, S, D) activations, w (D, V) head weights in x's
    dtype, targets (B, S) ints. Returns the f32 scalar loss; gradients
    flow to x and w without the logits ever existing."""
    b, s, d = x.shape
    if w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f"w must be ({d}, V), got {tuple(w.shape)}")
    x2 = x.reshape(b * s, d)
    t = targets.reshape(b * s).long().contiguous()
    return _FusedLinearCE.apply(x2, w.to(x.dtype), t, float(z_loss_weight),
                                int(chunk))
