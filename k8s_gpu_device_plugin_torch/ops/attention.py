"""Serving cache-attention dispatch and its static backend plan.

Port of ``k8s_gpu_device_plugin_tpu/ops/attention.py``
``serving_cache_attention`` and ``attention_backend_plan``. The
reference routes a shape onto its Pallas kernel only when opted in and
otherwise runs an XLA gather; here there is one route per device:
CUDA tensors go to the hand-written ragged-paged kernel (decode T=1 and
every prefill chunk alike) and CPU tensors to its plain version. A
shape the kernel does not take raises; it never falls back.
"""

from __future__ import annotations

import torch

from k8s_gpu_device_plugin_torch.ops import kernel_support
from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa


def serving_cache_attention(
    q: torch.Tensor,              # (B, T, Hq, hd)
    k_cache: torch.Tensor,        # dense (B, S, Hkv, hd)
    v_cache: torch.Tensor,
    length: "int | torch.Tensor",  # scalar or (B,) int: first-query position
    *,
    window: int = 0,
) -> torch.Tensor:
    """One serving cache-attention call: query r of slot b sits at
    ``length[b] + r`` (decode's single query at ``length``)."""
    b, _, _, hd = q.shape
    if isinstance(length, torch.Tensor):
        base = length.to(device=q.device, dtype=torch.int32).expand(b)
        base = base.contiguous()
    else:
        base = torch.full((b,), int(length), dtype=torch.int32, device=q.device)
    return rpa.ragged_paged_attention(
        q, k_cache, v_cache, base, scale=hd ** -0.5, window=window
    )


def attention_backend_plan(
    *,
    device: "str | torch.device",
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    chunk: int = 0,
    window: int = 0,
) -> dict:
    """{"decode"|"prefill": {"backend": "cuda"|"plain"|"unsupported",
    "reason": ...}}: which backend each serving mode takes on
    ``device`` and why, from config facts alone — the startup report
    ``/v1/health``'s ``decode_attn`` section carries. "unsupported"
    means the kernel would raise on this geometry; the batcher refuses
    such a config at construction."""
    dev = torch.device(device)

    def gate(mode: str) -> dict:
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
        reason = "hand-written ragged-paged CUDA kernel (sm_90a)"
        if mode == "prefill" and chunk:
            reason += f", chunk of {chunk} rows"
        if window > 0:
            reason += f", sliding window={window}"
        return {"backend": "cuda", "reason": reason}

    plan = {mode: gate(mode) for mode in ("decode", "prefill")}
    for entry in plan.values():
        entry["window"] = int(window)
    return plan
