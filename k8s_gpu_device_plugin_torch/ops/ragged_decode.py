"""Ragged decode attention: the T = 1 dense face of the ragged-paged
kernel.

Port of ``k8s_gpu_device_plugin_tpu/ops/ragged_decode.py``: the
lengths-based calling convention (the query of row b sits at
``lengths[b] - 1``) over a dense cache, a call of
``ops/ragged_paged_attention.py``'s wrapper with ``base = lengths - 1``.
No kernel of its own: a CUDA tensor launches the ragged-paged kernel,
which reads only each row's live span (and its window), a CPU tensor
takes the plain version. The serving path goes through
``ops/attention.serving_cache_attention`` and never imports this module.
"""

from __future__ import annotations

import torch

from k8s_gpu_device_plugin_torch.ops import kernel_support
from k8s_gpu_device_plugin_torch.ops.ragged_paged_attention import (
    MAX_GROUP,
    ragged_paged_attention,
)


def supports(q: torch.Tensor, k_cache: torch.Tensor,
             hd_ok=(64, 128)) -> bool:
    """Shape gate: T == 1, a lane-aligned head dim in ``hd_ok``, whole
    GQA groups the kernel folds, a dense cache row per query row."""
    if q.dim() != 4 or k_cache.dim() != 4 or q.shape[1] != 1:
        return False
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    return (hd in hd_ok and kernel_support.lane_aligned(hd)
            and k_cache.shape[0] == b and k_cache.shape[3] == hd
            and kernel_support.gqa_ok(hq, hkv) and hq // hkv <= MAX_GROUP)


def ragged_decode_attention(
    q: torch.Tensor,          # (B, 1, Hq, hd)
    k_cache: torch.Tensor,    # (B, S, Hkv, hd)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,    # (B,) int live rows per slot (query at len-1)
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """(B, 1, Hq, hd) decode attention over each row's live rows: the
    ragged-paged kernel at T = 1 with ``base = lengths - 1`` (an empty row
    clamps to attending row 0, computed and discarded)."""
    if q.shape[1] != 1:
        raise ValueError(f"ragged decode attention takes T == 1, got "
                         f"T={q.shape[1]}")
    return ragged_paged_attention(
        q, k_cache, v_cache, (lengths.to(torch.int32) - 1).contiguous(),
        scale=scale, window=window)
