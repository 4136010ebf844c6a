"""Paged decode and the speculative verify window: the page-table faces
of the ragged-paged kernel.

Port of ``k8s_gpu_device_plugin_tpu/ops/paged_attention.py``. Both entry
points are calls of ``ops/ragged_paged_attention.py``'s wrapper through
a page table: ``T = 1`` is paged decode, ``2 <= T <= MAX_VERIFY_T`` the
speculative verify window (query t of slot b sits at ``base[b] + t`` and
keeps keys ``<= base + t``, the mask of the dense verify). They have no
kernel of their own: a CUDA tensor launches the ragged-paged kernel, a
CPU tensor takes its plain version. The serving path goes through
``ops/attention.serving_cache_attention``; this module is the op-level
surface direct callers and the speculative tests use.
"""

from __future__ import annotations

import torch

from k8s_gpu_device_plugin_torch.ops import kernel_support
from k8s_gpu_device_plugin_torch.ops.ragged_paged_attention import (
    MAX_GROUP,
    MAX_VERIFY_T,
    page_size_refusal,
    ragged_paged_attention,
)


def _pages_ok(q: torch.Tensor, k_pool: torch.Tensor, pages: torch.Tensor,
              hd_ok) -> bool:
    """The shape gate both faces share: a lane-aligned head dim in
    ``hd_ok``, whole GQA groups the kernel folds, a page size the paged
    route takes and a table row per slot."""
    if q.dim() != 4 or k_pool.dim() != 4 or pages.dim() != 2:
        return False
    b, _, hq, hd = q.shape
    hkv = k_pool.shape[2]
    return (hd in hd_ok and kernel_support.lane_aligned(hd)
            and k_pool.shape[3] == hd and kernel_support.gqa_ok(hq, hkv)
            and hq // hkv <= MAX_GROUP
            and page_size_refusal(k_pool.shape[1]) is None
            and pages.shape[0] == b)


def supports(q: torch.Tensor, k_pool: torch.Tensor, pages: torch.Tensor,
             hd_ok=(64, 128)) -> bool:
    """Shape gate for paged decode: T == 1 over a pool the kernel takes."""
    return q.dim() == 4 and q.shape[1] == 1 and _pages_ok(q, k_pool, pages,
                                                          hd_ok)


def supports_verify(q: torch.Tensor, k_pool: torch.Tensor,
                    pages: torch.Tensor, hd_ok=(64, 128)) -> bool:
    """Shape gate for the verify window: 2 <= T <= MAX_VERIFY_T over the
    same pools the T == 1 face takes."""
    return (q.dim() == 4 and 2 <= q.shape[1] <= MAX_VERIFY_T
            and _pages_ok(q, k_pool, pages, hd_ok))


def paged_decode_attention(
    q: torch.Tensor,          # (B, 1, Hq, hd)
    k_pool: torch.Tensor,     # (n_pages, page_size, Hkv, hd)
    v_pool: torch.Tensor,
    pages: torch.Tensor,      # (B, n_slot_pages) int32 page table
    lengths: torch.Tensor,    # (B,) int live rows per slot (query at len-1)
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """(B, 1, Hq, hd) decode attention through the page table: the
    ragged-paged kernel at T = 1 with ``base = lengths - 1``."""
    if q.shape[1] != 1:
        raise ValueError(f"paged decode attention takes T == 1, got "
                         f"T={q.shape[1]}")
    return ragged_paged_attention(
        q, k_pool, v_pool, (lengths.to(torch.int32) - 1).contiguous(), pages,
        scale=scale, window=window)


def paged_verify_attention(
    q: torch.Tensor,          # (B, T, Hq, hd): T = the verify window
    k_pool: torch.Tensor,     # (n_pages, page_size, Hkv, hd)
    v_pool: torch.Tensor,
    pages: torch.Tensor,      # (B, n_slot_pages) int32 page table
    base: torch.Tensor,       # (B,) int position of each slot's first query
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """(B, T, Hq, hd) verify attention through the page table: the
    speculative round's window for every slot in one launch, the
    ragged-paged kernel at T = gamma."""
    if not 2 <= q.shape[1] <= MAX_VERIFY_T:
        raise ValueError(
            f"a verify window holds 2..{MAX_VERIFY_T} rows, got "
            f"T={q.shape[1]} (paged_decode_attention takes T == 1)")
    return ragged_paged_attention(
        q, k_pool, v_pool, base.to(torch.int32).contiguous(), pages,
        scale=scale, window=window, verify=True)
