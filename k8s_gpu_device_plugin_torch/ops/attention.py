"""Attention dispatch: full-sequence (training) and serving-cache entries.

Port of ``k8s_gpu_device_plugin_tpu/ops/attention.py``:

- :func:`attention`, the full-sequence entry the model's forward uses:
  on a CUDA tensor the hand-written flash kernels, which raise on shapes
  they do not take (``flash_attention.refusal``); on a CPU tensor
  :func:`mha_reference` (f32 softmax, causal and window masks, GQA), as
  the reference does off the TPU. A CUDA call reaches ``mha_reference``
  only when its caller asks for the plain path (``plain=True``), and is
  then counted under :data:`MHA_ROUTE` in
  ``kernel_support.launch_counts()``.
- ``serving_cache_attention`` and ``attention_backend_plan``. The
  reference routes a shape onto its Pallas kernel only when opted in
  and otherwise runs an XLA gather; here there is one route per device:
  CUDA tensors go to the hand-written ragged-paged kernel (decode T=1,
  verify windows and every prefill chunk alike; dense or paged cache,
  bf16/f32, int8 codes or packed int4 codes) and CPU tensors to its
  plain version. A shape
  the kernel does not take raises; it never falls back.
"""

from __future__ import annotations

import torch

from k8s_gpu_device_plugin_torch.ops import flash_attention as fa
from k8s_gpu_device_plugin_torch.ops import kernel_support
from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa

#: launch-count key of a CUDA attention call that asked for mha_reference
MHA_ROUTE = "attention_route{mha_reference}"


def _expand_kv(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    if k.shape[2] == n_q_heads:
        return k
    return k.repeat_interleave(n_q_heads // k.shape[2], dim=2)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: "float | None" = None,
                  window: int = 0) -> torch.Tensor:
    """(B, S, H, hd) attention with an f32 softmax; K/V may be grouped.
    ``window > 0`` keeps keys in (i - window, i] (causal only)."""
    if window > 0 and not causal:
        raise ValueError("sliding window requires causal attention")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    k = _expand_kv(k, q.shape[2])
    v = _expand_kv(v, q.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        keep = pos[:, None] >= pos[None, :]
        if window > 0:
            keep &= pos[:, None] - pos[None, :] < window
        scores = torch.where(keep, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: "float | None" = None,
              window: int = 0, *, plain: bool = False) -> torch.Tensor:
    """Dispatching full-sequence attention, (B, S, H, hd): the flash
    kernels on a CUDA tensor (raising on shapes they do not take),
    :func:`mha_reference` on a CPU one. ``plain=True`` runs
    :func:`mha_reference` whatever the device: the comparison path a card
    run holds the kernel path against; training never sets it."""
    if q.device.type == "cuda":
        if not plain:
            return fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                      window=window)
        kernel_support.count_launch(MHA_ROUTE)
    return mha_reference(q, k, v, causal=causal, scale=scale, window=window)


def serving_cache_attention(
    q: torch.Tensor,              # (B, T, Hq, hd)
    k_cache: torch.Tensor,        # dense (B, S, Hkv, hd) | paged pool
    v_cache: torch.Tensor,
    length: "int | torch.Tensor",  # scalar or (B,) int: first-query position
    pages: "torch.Tensor | None" = None,  # (B, n_slot_pages) int32
    verify: bool = False,
    *,
    window: int = 0,
    k_scale: "torch.Tensor | None" = None,
    v_scale: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """One serving cache-attention call: query r of slot b sits at
    ``length[b] + r`` (decode's single query at ``length``). ``pages``
    marks the caches as a paged pool; ``k_scale``/``v_scale`` mark them
    as codes (int8, or int4 packed into uint8). ``verify`` says the T
    rows are a speculative verify
    window, which the reference bounds at 2 <= T <= ``MAX_VERIFY_T``: a
    wider or narrower one raises, so a prefill chunk can never pass for
    one."""
    b, t, _, hd = q.shape
    if verify and not 2 <= t <= rpa.MAX_VERIFY_T:
        raise ValueError(
            f"a verify window holds 2..{rpa.MAX_VERIFY_T} rows, got T={t}"
        )
    if isinstance(length, torch.Tensor):
        base = length.to(device=q.device, dtype=torch.int32).expand(b)
        base = base.contiguous()
    else:
        base = torch.full((b,), int(length), dtype=torch.int32, device=q.device)
    return rpa.ragged_paged_attention(
        q, k_cache, v_cache, base, pages, scale=hd ** -0.5, window=window,
        k_scale=k_scale, v_scale=v_scale,
    )


def attention_backend_plan(
    *,
    device: "str | torch.device",
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    kv_layout: str = "dense",
    page_size: int = 0,
    cache_quant: str = "none",
    chunk: int = 0,
    window: int = 0,
) -> dict:
    """{"decode"|"verify"|"prefill": {"backend": "cuda"|"plain"|
    "unsupported", "reason": ...}}: which backend each serving mode
    takes on ``device`` and why, from config facts alone: the startup
    report ``/v1/health``'s ``decode_attn`` section carries.
    "unsupported" means the wrapper would raise on this geometry (a head
    dim, a GQA group or a page size off the kernel's gate); the batcher
    refuses such a config at construction."""
    dev = torch.device(device)
    route = rpa.route_name(kv_layout == "paged", cache_quant)

    def gate(mode: str) -> dict:
        why = rpa.page_size_refusal(page_size) if kv_layout == "paged" else None
        if why:
            return {"backend": "unsupported", "reason": why}
        if dev.type == "cpu":
            return {"backend": "plain", "reason":
                    "CPU tensors take the plain PyTorch version"}
        if not kernel_support.lane_aligned(head_dim):
            return {"backend": "unsupported", "reason":
                    f"head_dim={head_dim} not in "
                    f"{kernel_support.LANE_ALIGNED_HEAD_DIMS}"}
        if not kernel_support.gqa_ok(n_heads, n_kv_heads) or \
                n_heads // n_kv_heads > rpa.MAX_GROUP:
            return {"backend": "unsupported", "reason":
                    f"n_heads={n_heads} not a multiple of n_kv_heads="
                    f"{n_kv_heads} with a group <= {rpa.MAX_GROUP}"}
        reason = (f"hand-written ragged-paged CUDA kernel (sm_90a), "
                  f"route {route}")
        if kv_layout == "paged":
            reason += f", pages of {page_size} rows"
        if mode == "prefill" and chunk:
            reason += f", chunk of {chunk} rows"
        if mode == "verify":
            reason += f", windows of 2..{rpa.MAX_VERIFY_T} rows"
        if window > 0:
            reason += f", sliding window={window}"
        return {"backend": "cuda", "reason": reason}

    plan = {mode: gate(mode) for mode in ("decode", "verify", "prefill")}
    for entry in plan.values():
        entry["window"] = int(window)
        entry["route"] = route
    return plan
