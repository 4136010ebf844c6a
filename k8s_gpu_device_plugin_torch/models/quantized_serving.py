"""Quantized serving: what the port serves of it so far.

Port of ``k8s_gpu_device_plugin_tpu/models/quantized_serving.py``'s
``check_cache_quant_kv_layout``. The weight-only int8/int4 path
(``quantize_weights``, ``qmatmul``) is not ported yet (ROADMAP A9).
"""

from __future__ import annotations

CACHE_QUANTS = ("none", "int8", "int4")
KV_LAYOUTS = ("dense", "paged")


def check_cache_quant_kv_layout(cfg) -> None:
    """The one place that validates the ``(cache_quant, kv_layout)``
    pair. Both layouts hold a bf16/f32 cache or int8 codes with their
    f32 scale planes on the same geometry, so every pair of served
    values is served; the reference's backend probe (can the runtime
    scatter a narrow dtype into a pool) has no counterpart here, since
    int8 is an ordinary torch dtype. ``'int4'`` is refused by name: it
    needs the port's own two-codes-per-byte layout."""
    if cfg.cache_quant not in CACHE_QUANTS:
        raise ValueError(
            f"cache_quant must be one of {CACHE_QUANTS}, got "
            f"{cfg.cache_quant!r}: an unknown value would silently run an "
            "unquantized cache"
        )
    if cfg.kv_layout not in KV_LAYOUTS:
        raise ValueError(
            f"kv_layout must be one of {KV_LAYOUTS}, got {cfg.kv_layout!r}: "
            "an unknown value would silently serve the dense layout"
        )
    if cfg.cache_quant == "int4":
        raise NotImplementedError(
            f"cache_quant='int4' (kv_layout={cfg.kv_layout!r}): int4 KV "
            "codes need a two-codes-per-byte layout that is not ported yet "
            "(ROADMAP A9, B7); serve cache_quant='int8' or 'none'"
        )
