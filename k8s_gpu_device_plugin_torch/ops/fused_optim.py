"""Fused AdamW: clip, bias correction, decoupled weight decay and the
parameter write in one elementwise pass a leaf.

Port of ``k8s_gpu_device_plugin_tpu/ops/fused_optim.py``. The reference
is not a TPU kernel: it is plain JAX, two HBM passes that XLA fuses (the
global-norm read over the grads, then one read(g, m, v, p)/write(m, v, p)
pass, "the floor for AdamW"). Eager PyTorch fuses nothing, so the port
writes both passes as hand-written kernels (``csrc/fused_adamw.cu``):

- the norm pass: one launch a leaf writes per-block partial sums of g^2
  (in double), one finalize launch sums them in a fixed order and writes
  the global norm and the clip scale to device memory (no atomics: a
  run's losses repeat bit for bit);
- the update: one launch a leaf, 16-byte vector loads, ``scale`` read
  from device memory, m, v and p written in place, bf16 or f32 leaves.

Both are bound by bytes: 16 B a bf16 parameter (g, m, v, p read, m, v, p
written, g read once more by the norm pass), 32 B an f32 one.

Numerics are the reference fused path's, not optax's (they differ in
rounding): ``scale = min(1, clip / max(norm, 1e-16))`` multiplied into g;
``lr = schedule(count)`` before the increment; bias corrections at
``count + 1`` computed in f32; ``p - lr * (u + wd * p)``; f32 math for
each element, m, v and p rounded once to the parameter dtype. The global
norm is taken in f32 whatever the grads' dtype, as the port's
``models/train.py::AdamW`` takes it (the reference's ``optax.global_norm``
sums bf16 grads in bf16). The kernel's arithmetic is explicitly rounded
operation by operation, in the order :func:`fused_adamw_update` computes
it, so the two agree bit for bit whenever they see the same ``scale``.

:class:`FusedAdamW` has the interface of ``models/train.py::AdamW``
(``init(params) -> {"count", "mu", "nu"}``, ``update(grads, state,
params) -> grad_norm`` in place), so the train step and checkpoints take
either. Its ``update`` launches the kernels for CUDA tensors and takes
:func:`fused_adamw_update` only for CPU tensors. The update count is a
host integer and ``lr``, the bias corrections and the clip are host
scalars: nothing waits on the card, and ``grad_norm`` stays a device
tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import numpy as np
import torch

from k8s_gpu_device_plugin_torch.ops import kernel_support

SOURCE = kernel_support.CSRC_DIR / "fused_adamw.cu"

#: launch counts: the update (one a leaf) and the norm pass (one a leaf,
#: plus the finalize)
NAME = "fused_adamw"
NORM_NAME = "fused_adamw[norm]"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    "adamw_partials": [_L, _I],
    "adamw_sumsq_launch": [_P, _L, _I, _P, _P],
    "adamw_finalize_launch": [_P, _I, _F, _P, _P],
    "adamw_update_launch": [_P, _P, _P, _P, _L, _I, _P] + [_F] * 9 + [_P],
}


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = kernel_support.load_library("fused_adamw", [SOURCE])
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def bias_corrections(b1: float, b2: float, count: int) -> tuple[float, float]:
    """(1 - b1^c, 1 - b2^c) at ``c = count + 1``, in f32 as the reference
    computes them."""
    c = np.float32(count + 1)
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** c), float(one - np.float32(b2) ** c))


# --- the plain version ----------------------------------------------------------


def _scalar(like: torch.Tensor, value) -> torch.Tensor:
    """An f32 0-d tensor on ``like``'s device: every scalar of the plain
    version is a tensor, so no operation of it takes PyTorch's
    host-scalar shortcuts (a division by a host scalar is a multiplication
    by its reciprocal on the card)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, as an f32 scalar."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_scale(norm: torch.Tensor, clip: float) -> torch.Tensor:
    """``min(1, clip / max(norm, 1e-16))`` in f32."""
    return torch.minimum(_scalar(norm, 1.0),
                         _scalar(norm, clip) / torch.clamp(norm, min=1e-16))


@torch.no_grad()
def fused_adamw_update(params: list, grads: list, mu: list, nu: list,
                       count: int, *, lr: float, b1: float, b2: float,
                       eps: float, weight_decay: float, clip: float,
                       scale: "torch.Tensor | None" = None) -> torch.Tensor:
    """One AdamW step with global-norm clipping, the plain version of the
    kernels: updates ``params``, ``mu`` and ``nu`` in place and returns
    the global norm of ``grads`` (before clipping). ``count`` is the
    update count before this step. ``scale`` replaces the clip scale the
    norm gives (a comparison feeds the kernels' own)."""
    norm = global_norm(grads)
    if scale is None:
        scale = clip_scale(norm, clip)
    bc1, bc2 = bias_corrections(b1, b2, count)
    like = params[0]
    s = {name: _scalar(like, value) for name, value in (
        ("lr", lr), ("b1", b1), ("omb1", 1.0 - b1), ("b2", b2),
        ("omb2", 1.0 - b2), ("bc1", bc1), ("bc2", bc2), ("eps", eps),
        ("wd", weight_decay))}
    for p, g, m, v in zip(params, grads, mu, nu):
        g32 = g.float() * scale
        m32 = s["b1"] * m.float() + s["omb1"] * g32
        v32 = s["b2"] * v.float() + s["omb2"] * g32 * g32
        upd = (m32 / s["bc1"]) / (torch.sqrt(v32 / s["bc2"]) + s["eps"])
        p32 = p.float()
        p.copy_(p32 - s["lr"] * (upd + s["wd"] * p32))
        m.copy_(m32)
        v.copy_(v32)
    return norm


# --- the kernels' wrappers ------------------------------------------------------


def _check_leaf(p: torch.Tensor, *others: torch.Tensor) -> None:
    if p.dtype not in _DTYPES:
        raise ValueError(f"fused AdamW takes bf16 or f32 leaves, got {p.dtype}")
    for x in (p, *others):
        if x.device != p.device or x.dtype != p.dtype or x.shape != p.shape:
            raise ValueError(
                f"a leaf's g, m, v and p must share device, dtype and shape; "
                f"got {x.device} {x.dtype} {tuple(x.shape)} beside "
                f"{p.device} {p.dtype} {tuple(p.shape)}"
            )
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("fused AdamW operands must be contiguous and "
                             "16-byte aligned")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def norm_and_scale(grads: list, clip: float) -> torch.Tensor:
    """The norm pass on the card: f32 (2,) = (global norm, clip scale),
    from one partials launch a leaf and one finalize launch."""
    lib = load_kernel()
    dev = grads[0].device
    counts = [lib.adamw_partials(g.numel(), _DTYPES[g.dtype]) for g in grads]
    partial = torch.empty(sum(counts), dtype=torch.float64, device=dev)
    gn = torch.empty(2, dtype=torch.float32, device=dev)
    offset = 0
    for g, n_part in zip(grads, counts):
        _raise_on(lib.adamw_sumsq_launch(
            g.data_ptr(), g.numel(), _DTYPES[g.dtype],
            partial.data_ptr() + 8 * offset, _stream(g)), NORM_NAME)
        kernel_support.count_launch(NORM_NAME)
        offset += n_part
    _raise_on(lib.adamw_finalize_launch(partial.data_ptr(), offset,
                                        float(clip), gn.data_ptr(),
                                        _stream(gn)), NORM_NAME)
    kernel_support.count_launch(NORM_NAME)
    return gn


def fused_adamw_kernels(params: list, grads: list, mu: list, nu: list,
                        count: int, *, lr: float, b1: float, b2: float,
                        eps: float, weight_decay: float,
                        clip: float) -> torch.Tensor:
    """:func:`fused_adamw_update` through the kernels (CUDA tensors):
    returns f32 (2,) = (global norm, the clip scale the update used) on
    the device."""
    grads = [g.contiguous() for g in grads]
    for p, g, m, v in zip(params, grads, mu, nu):
        _check_leaf(p, g, m, v)
        if p.device.type != "cuda":
            raise ValueError(f"unsupported device {p.device}")
    gn = norm_and_scale(grads, clip)
    bc1, bc2 = bias_corrections(b1, b2, count)
    hyper = (float(lr), float(b1), float(1.0 - b1), float(b2),
             float(1.0 - b2), bc1, bc2, float(eps), float(weight_decay))
    lib = load_kernel()
    for p, g, m, v in zip(params, grads, mu, nu):
        _raise_on(lib.adamw_update_launch(
            g.data_ptr(), m.data_ptr(), v.data_ptr(), p.data_ptr(),
            p.numel(), _DTYPES[p.dtype], gn.data_ptr(), *hyper,
            _stream(p)), NAME)
        kernel_support.count_launch(NAME)
    return gn


def launches_per_update(n_leaves: int) -> dict[str, int]:
    """The launches one :meth:`FusedAdamW.update` makes over ``n_leaves``
    leaves on the card."""
    return {NAME: n_leaves, NORM_NAME: n_leaves + 1}


class FusedAdamW:
    """The reference's ``FusedAdamW`` with ``models/train.py::AdamW``'s
    interface. State: ``{"count": int, "mu": [...], "nu": [...]}``,
    moments in the parameters' dtype."""

    def __init__(self, schedule: Callable[[int], float], *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip: float = 1.0) -> None:
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip = clip

    def init(self, params: list) -> dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads: list, state: dict, params: list) -> torch.Tensor:
        """Apply one update to ``params`` and ``state`` in place; returns
        the global norm of ``grads`` (before clipping). The count moves
        before the leaves are written, so a step that an exception stops
        halfway is seen as torn (``models/trainer.py::_whole``)."""
        count = state["count"]
        lr = self.schedule(count)
        state["count"] = count + 1
        kw = dict(lr=lr, b1=self.b1, b2=self.b2, eps=self.eps,
                  weight_decay=self.weight_decay, clip=self.clip)
        if params[0].device.type == "cpu":
            return fused_adamw_update(params, list(grads), state["mu"],
                                      state["nu"], count, **kw)
        return fused_adamw_kernels(params, list(grads), state["mu"],
                                   state["nu"], count, **kw)[0]


def fused_adamw_step(opt: FusedAdamW, params: list, grads: list,
                     state: dict) -> torch.Tensor:
    """The reference's step function over lists: ``opt.update`` (the
    plain version on the CPU, the kernels on the card)."""
    return opt.update(grads, state, params)
