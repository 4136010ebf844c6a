"""Parameter and KV-cache conversion between the JAX reference and the
port.

The two packages share one weight layout (models/llama.py states it):
stacked ``layers`` leaves with a leading layer axis, projections stored
``(in, out)``, ``embed`` (V, d), ``final_norm`` (d,), ``lm_head`` (d, V).
So conversion is a per-leaf copy with no transposes — the parity tests
feed both frameworks the same numbers. A KV cache converts the same way
(:func:`kv_cache_from_jax`): both packages keep one geometry per layout,
so tests can start both from one cache.

Quantized leaves keep their own dtypes: the reference's weight-only
``{"q": int8, "s": f32}`` and ``{"q4": int4, "s": f32}`` leaves, and its
int8/int4 caches. ``jnp.int4`` arrives as an ml_dtypes int4 array; it is
widened to int8 and packed two codes per byte (``ops/quant.py``), the
port's storage of int4 codes.
"""

from __future__ import annotations

import numpy as np
import torch

from k8s_gpu_device_plugin_torch.device import resolve_device
from k8s_gpu_device_plugin_torch.models.generate import KVCache
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig
from k8s_gpu_device_plugin_torch.ops.quant import pack_int4


def _tensor(arr, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    arr = np.array(arr, order="C")  # an owned, writable copy
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes provides one torch
        # cannot read): move the raw 16-bit patterns and reinterpret
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def _int4_tensor(arr, device: torch.device) -> torch.Tensor:
    """An int4 array (ml_dtypes, or any integer codes in [-8, 7]) -> its
    packed uint8 tensor on ``device``."""
    codes = torch.from_numpy(np.asarray(arr).astype(np.int8))
    return pack_int4(codes).to(device)


def _leaf(arr, dtype: torch.dtype, device: torch.device):
    """One params leaf: a float array in ``dtype``, or a quantized leaf
    dict with its codes and f32 scales in their own dtypes."""
    if not isinstance(arr, dict):
        return _tensor(arr, dtype, device)
    if set(arr) == {"q", "s"}:
        return {"q": _tensor(arr["q"], torch.int8, device),
                "s": _tensor(arr["s"], torch.float32, device)}
    if set(arr) == {"q4", "s"}:
        return {"q4": _int4_tensor(arr["q4"], device),
                "s": _tensor(arr["s"], torch.float32, device)}
    raise ValueError(f"unknown quantized leaf with keys {sorted(arr)}")


def _logical_shape(leaf) -> tuple:
    """The (unpacked) shape a float or quantized leaf stands for."""
    if isinstance(leaf, dict) and "q4" in leaf:
        *lead, half = leaf["q4"].shape
        return (*lead, 2 * half)
    return tuple((leaf["q"] if isinstance(leaf, dict) else leaf).shape)


def params_from_jax(np_params: dict, cfg: LlamaConfig,
                    device: "str | torch.device | None" = "cuda") -> dict:
    """The reference's params pytree, as numpy arrays (``layers`` leaves
    stacked, plus ``embed``, ``final_norm`` and — unless tied —
    ``lm_head``), -> the port's params on ``device`` in ``cfg.p_dtype``.
    Weight-only quantized leaves (the reference's
    ``quantize_weights_int8``/``int4`` output) keep their codes and f32
    scales, int4 codes packed. Refuses a tree that does not match
    ``cfg``'s shapes."""
    dev = resolve_device(device)
    expected = {"embed", "layers", "final_norm"}
    # a quantized tree carries its head even when tied (the reference
    # quantizes embed.T into an lm_head leaf)
    if not cfg.tied_embeddings or isinstance(np_params.get("lm_head"), dict):
        expected.add("lm_head")
    if set(np_params) != expected:
        raise ValueError(
            f"params carry {sorted(np_params)}, expected {sorted(expected)}"
        )
    out = {
        "embed": _tensor(np_params["embed"], cfg.p_dtype, dev),
        "final_norm": _tensor(np_params["final_norm"], cfg.p_dtype, dev),
        "layers": {
            name: _leaf(leaf, cfg.p_dtype, dev)
            for name, leaf in np_params["layers"].items()
        },
    }
    if "lm_head" in np_params:
        out["lm_head"] = _leaf(np_params["lm_head"], cfg.p_dtype, dev)
    d, hd = cfg.d_model, cfg.head_dim
    want = {
        "embed": (cfg.vocab_size, d),
        "final_norm": (d,),
        "lm_head": (d, cfg.vocab_size),
    }
    for name, shape in want.items():
        if name in out and _logical_shape(out[name]) != shape:
            raise ValueError(
                f"{name} is {_logical_shape(out[name])}, cfg wants {shape}"
            )
    wq = _logical_shape(out["layers"]["wq"])
    if wq != (cfg.n_layers, d, cfg.n_heads * hd):
        raise ValueError(
            f"layers.wq is {wq}, cfg wants "
            f"{(cfg.n_layers, d, cfg.n_heads * hd)}"
        )
    return out


def params_to_numpy(params: dict) -> dict:
    """The reverse per-leaf copy: the port's params -> the same tree of
    numpy arrays on the host (bf16 leaves widened to f32, exactly:
    numpy has no bfloat16 of its own)."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            out[name] = params_to_numpy(leaf)
        else:
            x = leaf.detach().cpu()
            out[name] = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return out


def kv_cache_from_jax(np_cache: dict, cfg: LlamaConfig,
                      device: "str | torch.device | None" = "cuda") -> KVCache:
    """The leaves of a reference ``KVCache`` as numpy arrays, ``{"k",
    "v", "k_scale", "v_scale"}`` (the scales None or absent on an
    unquantized cache), dense (L, B, S, Hkv, hd) or a paged pool
    (L, n_pages, page_size, Hkv, hd), -> the port's ``KVCache`` on
    ``device`` with the same bytes (int4 codes: the same codes, packed
    two per byte). Refuses leaves that do not match ``cfg``'s cache
    dtype and geometry."""
    dev = resolve_device(device)
    quantized = cfg.cache_quant in ("int8", "int4")
    k, v = np_cache["k"], np_cache["v"]
    scales = (np_cache.get("k_scale"), np_cache.get("v_scale"))
    if quantized != all(s is not None for s in scales) or \
            quantized != any(s is not None for s in scales):
        raise ValueError(
            f"cache_quant={cfg.cache_quant!r} wants "
            f"{'both' if quantized else 'no'} scale planes"
        )
    want_dtype = cfg.cache_quant if quantized else str(cfg.dtype).split(".")[-1]
    want_tail = (cfg.n_kv_heads, cfg.head_dim)
    for name, leaf in (("k", k), ("v", v)):
        if leaf.dtype.name != want_dtype or leaf.ndim != 5 or \
                leaf.shape[0] != cfg.n_layers or leaf.shape[3:] != want_tail:
            raise ValueError(
                f"{name} is {leaf.dtype.name} {leaf.shape}, cfg wants "
                f"{want_dtype} ({cfg.n_layers}, *, *, {want_tail[0]}, "
                f"{want_tail[1]})"
            )
    for name, leaf in zip(("k_scale", "v_scale"), scales):
        if leaf is not None and (leaf.dtype.name != "float32"
                                 or leaf.shape != (*k.shape[:-1], 1)):
            raise ValueError(
                f"{name} is {leaf.dtype.name} {leaf.shape}, wanted float32 "
                f"{(*k.shape[:-1], 1)}"
            )
    if cfg.cache_quant == "int4":
        k, v = _int4_tensor(k, dev), _int4_tensor(v, dev)
    else:
        kv_dtype = torch.int8 if quantized else cfg.dtype
        k, v = _tensor(k, kv_dtype, dev), _tensor(v, kv_dtype, dev)
    return KVCache(
        k=k, v=v,
        k_scale=None if scales[0] is None else _tensor(scales[0],
                                                        torch.float32, dev),
        v_scale=None if scales[1] is None else _tensor(scales[1],
                                                        torch.float32, dev),
    )
