"""Ragged-paged attention: the serving cache-attention kernel's wrapper
and its plain PyTorch version.

Port of ``k8s_gpu_device_plugin_tpu/ops/ragged_paged_attention.py``
(entry ``ragged_paged_attention``, kernel ``_rpa_kernel``). A batch of
query windows, each at a per-slot base position, attends the slot's
live span of the KV cache: row r of slot b sits at
``q_pos = max(base[b] + r, 0)`` and keeps cache rows ``pos <= q_pos``
(and ``q_pos - pos < window`` when ``window > 0``). T = 1 is decode,
T > 1 a prefill chunk (or a verify window); any T works, because the
kernel's row tiles are independent blocks.

- CUDA tensors launch the hand-written kernel
  (``csrc/ragged_paged_attention.cu``), built at first use and counted
  in ``kernel_support.launch_counts()``; anything the kernel does not
  take raises.
- CPU tensors take :func:`ragged_paged_attention_reference`, the
  gather-einsum of the reference's ``generate._cached_attention`` with
  the kernel's ``q_pos`` clamp. Nothing gives way from the kernel to it.

This slice ports the dense route: a page table raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from k8s_gpu_device_plugin_torch.ops import kernel_support

NAME = "ragged_paged_attention"
SOURCE = kernel_support.CSRC_DIR / "ragged_paged_attention.cu"

#: widest GQA group one block folds (64 q vectors per row tile)
MAX_GROUP = 64

_NEG_BIG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attended_rows(base: torch.Tensor, t: int, window: int = 0) -> torch.Tensor:
    """(B, T) int64: how many cache rows query ``r`` of each slot
    attends. The kernel reads the live span
    ``first_block(base + 1) .. last_block(base + T)`` of its 64-row kv
    tiles (the C++ helpers of those names port the reference's
    ``_first_block``/``_last_block``); this is the data-dependent work
    a bound on it counts."""
    q_pos = torch.clamp(
        base[:, None].long() + torch.arange(t, device=base.device), min=0
    )
    rows = q_pos + 1
    if window > 0:
        rows = torch.clamp(rows, max=window)
    return rows


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = kernel_support.load_library(NAME, [SOURCE])
    fn = lib.rpa_dense_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, base) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(
            f"q must be (B, T, Hq, hd) and k/v (B, S, Hkv, hd); got "
            f"{tuple(q.shape)} and {tuple(k.shape)}"
        )
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} != v {tuple(v.shape)}")
    b, t, hq, hd = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(
            f"cache {tuple(k.shape)} does not match q {tuple(q.shape)}"
        )
    if not kernel_support.gqa_ok(hq, hkv) or hq // hkv > MAX_GROUP:
        raise ValueError(
            f"Hq={hq} must be a multiple of Hkv={hkv} with a group of at "
            f"most {MAX_GROUP}"
        )
    if base.shape != (b,):
        raise ValueError(f"base must be ({b},), got {tuple(base.shape)}")
    devs = {q.device, k.device, v.device, base.device}
    if len(devs) != 1:
        raise ValueError(f"q, k, v and base on different devices: {devs}")


def ragged_paged_attention(
    q: torch.Tensor,          # (B, T, Hq, hd)
    k: torch.Tensor,          # dense (B, S, Hkv, hd)
    v: torch.Tensor,
    base: torch.Tensor,       # (B,) int32: position of each slot's first query
    pages: "torch.Tensor | None" = None,
    *,
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """(B, T, Hq, hd) cache attention over each slot's live span, in q's
    dtype. The caller has already written the window's own K/V rows
    (the serving contract: live rows are ``base + T``)."""
    if pages is not None:
        raise NotImplementedError(
            "the paged route of ragged_paged_attention is not ported yet: "
            "pass pages=None with a dense (B, S, Hkv, hd) cache"
        )
    _check(q, k, v, base)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(q, k, v, base, scale=scale,
                                                window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, t, hq, hd = q.shape
    if not kernel_support.lane_aligned(hd):
        raise ValueError(f"head_dim={hd} not in {kernel_support.LANE_ALIGNED_HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q/k/v must share one dtype of {list(_DTYPES)}; got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if base.dtype != torch.int32:
        raise ValueError(f"base must be int32, got {base.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v), ("base", base)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = load_kernel()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.rpa_dense_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), base.data_ptr(),
        out.data_ptr(), _DTYPES[q.dtype], b, t, hq, k.shape[2], k.shape[1],
        hd, float(scale), int(window), stream,
    )
    if err != 0:
        raise RuntimeError(
            f"ragged_paged_attention kernel launch failed: cudaError {err} "
            f"(q {tuple(q.shape)} {q.dtype}, cache {tuple(k.shape)})"
        )
    kernel_support.count_launch(NAME)
    return out


def ragged_paged_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, base: torch.Tensor,
    *, scale: float, window: int = 0,
) -> torch.Tensor:
    """The plain version: the gather einsum of the reference's
    ``_cached_attention`` (scores from q's-dtype operands with f32
    accumulation, a plain f32 softmax over the whole cache, probs cast to
    q's dtype for the V contraction) plus the kernel's ``q_pos`` clamp,
    which changes nothing for a live slot (base >= 0). Runs on any
    device; the wrapper takes it only for CPU tensors."""
    b, t, hq, hd = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, t, hkv, group, hd).float()
    scores = torch.einsum("btkgd,bskd->btkgs", qg, k.to(q.dtype).float())
    scores = scores * scale
    q_pos = torch.clamp(
        base.long()[:, None] + torch.arange(t, device=q.device)[None, :],
        min=0,
    )[:, :, None, None, None]
    k_pos = torch.arange(s_len, device=q.device)[None, None, None, None, :]
    keep = k_pos <= q_pos
    if window > 0:
        keep &= q_pos - k_pos < window
    scores = torch.where(keep, scores, torch.full_like(scores, _NEG_BIG))
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    out = torch.einsum("btkgs,bskd->btkgd", probs, v.to(q.dtype).float())
    return out.reshape(b, t, hq, hd).to(q.dtype)
