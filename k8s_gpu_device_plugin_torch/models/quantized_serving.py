"""Quantized serving: the cache-quant check and weight-only int8/int4.

Port of ``k8s_gpu_device_plugin_tpu/models/quantized_serving.py``:
``check_cache_quant_kv_layout``, ``quantize_weights_int8``,
``quantize_weights_int4``, ``qmatmul``, ``_q4_matmul`` and
``qhead_matmul``, with the reference's leaf structure and algebra.

- int8: each projection/MLP stack (L, in, out) becomes ``{"q": int8
  (L, in, out), "s": f32 (L, 1, out)}``, one scale per (layer, output
  channel); ``x @ W`` is a product in x's dtype against the widened
  codes, then the f32 scale, then the cast back.
- int4: ``{"q4": uint8 (L, in, out / 2), "s": f32 (L, in / group,
  out)}``, the codes packed two per byte (``ops/quant.py`` states the
  layout), one scale per ``group`` input channels per output channel;
  ``x @ W`` contracts per group in x's dtype (``...gk,gkn->...gn``), then
  folds the f32 group scales in.
- The lm_head (d, V) is quantized the same way and projected with f32
  accumulation (:func:`qhead_matmul`); the embedding table and the norms
  keep their float dtype.

These products are the ones the reference leaves to XLA outside any
Pallas kernel; here they are eager ``torch.matmul``/``einsum``, which
widen the codes into a copy of x's dtype per product (no fusion). A
dequantizing GEMM kernel is later work. MoE expert stacks
(``moe_w1``/``moe_w3``/``moe_w2``, ``qexpert_einsum``) are refused with
MoE (ROADMAP A10).
"""

from __future__ import annotations

import torch

from k8s_gpu_device_plugin_torch.ops.quant import (
    dot_f32,
    pack_int4,
    quantize_int4_grouped,
    quantize_int8,
    unpack_int4,
)

CACHE_QUANTS = ("none", "int8", "int4")
KV_LAYOUTS = ("dense", "paged")
WEIGHT_QUANTS = ("none", "int8", "int4")

# weight leaves quantized per layer (contraction axis is axis -2 for all)
_QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
_MOE_QUANT_LEAVES = ("moe_w1", "moe_w3", "moe_w2")

#: default group size of int4 weight quantization
INT4_GROUP = 128


def check_cache_quant_kv_layout(cfg) -> None:
    """The one place that validates the ``(cache_quant, kv_layout)``
    pair. Both layouts hold a bf16/f32 cache, int8 codes or packed int4
    codes with their f32 scale planes on the same geometry, so every pair
    of served values is served; the reference's backend probe (can the
    runtime scatter a narrow dtype into a pool) has no counterpart here,
    since int8 and uint8 are ordinary torch dtypes."""
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


def _head_operand(params: dict) -> torch.Tensor:
    """The float head to quantize: the dedicated leaf, or embed.T for
    tied-embedding pytrees (the embedding gather keeps the float
    table)."""
    return params["lm_head"] if "lm_head" in params else params["embed"].T


def _quantized_layers(params: dict, quantize) -> dict:
    """Apply ``quantize`` ((in, out) -> leaf dict) to every targeted
    stack one layer at a time (the transient f32 copies stay one layer
    deep; every scale lies inside one layer, so the codes and scales are
    the whole stack's) and stack the layers' leaves back."""
    layers = {}
    for name, w in params["layers"].items():
        if name in _MOE_QUANT_LEAVES:
            raise NotImplementedError(
                f"quantizing the MoE expert stack {name!r}: MoE is not "
                "ported yet (ROADMAP A10)"
            )
        if name not in _QUANT_LEAVES:
            layers[name] = w
            continue
        per_layer = [quantize(w[i]) for i in range(w.shape[0])]
        layers[name] = {key: torch.stack([leaf[key] for leaf in per_layer])
                        for key in per_layer[0]}
    return layers


def _int8_leaf(w: torch.Tensor) -> dict:
    q, s = quantize_int8(w, axis=-2)     # contract over 'in'
    return {"q": q, "s": s}


def quantize_weights_int8(params: dict) -> dict:
    """Float params -> serving params with int8 projection/MLP weights
    and an int8 lm_head (per output channel). Embed and norms stay
    float."""
    return {
        **params,
        "layers": _quantized_layers(params, _int8_leaf),
        "lm_head": _int8_leaf(_head_operand(params)),
    }


def quantize_weights_int4(params: dict, group: int = INT4_GROUP) -> dict:
    """Float params -> serving params with int4 projection/MLP weights
    and lm_head: ``{"q4": packed uint8, "s": f32 group scales}``."""
    def leaf(w: torch.Tensor) -> dict:
        q, s = quantize_int4_grouped(w, group=group)
        return {"q4": pack_int4(q), "s": s}

    return {
        **params,
        "layers": _quantized_layers(params, leaf),
        "lm_head": leaf(_head_operand(params)),
    }


def quantize_weights(params: dict, weight_quant: str) -> dict:
    """The server's ``--weightQuant``: ``'none'`` returns ``params``."""
    if weight_quant not in WEIGHT_QUANTS:
        raise ValueError(
            f"weight_quant must be one of {WEIGHT_QUANTS}, got "
            f"{weight_quant!r}"
        )
    if weight_quant == "int8":
        return quantize_weights_int8(params)
    if weight_quant == "int4":
        return quantize_weights_int4(params)
    return params


def is_quantized_leaf(w) -> bool:
    return isinstance(w, dict) and set(w) == {"q", "s"}


def is_quantized4_leaf(w) -> bool:
    return isinstance(w, dict) and set(w) == {"q4", "s"}


def weight_quant_of(params: dict) -> str:
    """``'int8'``, ``'int4'`` or ``'none'``: what the lm_head leaf says
    (both recipes quantize it with the layer stacks)."""
    head = params.get("lm_head")
    if is_quantized_leaf(head):
        return "int8"
    if is_quantized4_leaf(head):
        return "int4"
    return "none"


def resident_bytes(params) -> int:
    """Device bytes every leaf of a params tree holds, codes and scales
    included."""
    if isinstance(params, dict):
        return sum(resident_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


def layer_slice(leaf, i: int):
    """Layer ``i`` of a stacked leaf: a tensor, or a quantized leaf dict
    whose every tensor is sliced."""
    if isinstance(leaf, dict):
        return {k: v[i] for k, v in leaf.items()}
    return leaf[i]


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where ``w`` is a float tensor, an int8 ``{"q", "s"}``
    leaf or an int4 ``{"q4", "s"}`` leaf. The codes are the product's
    operand (widened to x's dtype); the scales multiply the smaller
    result, per output channel (int8) or per group (int4)."""
    if is_quantized4_leaf(w):
        return _q4_matmul(x, w)
    if is_quantized_leaf(w):
        y = torch.matmul(x, w["q"].to(x.dtype))
        # the scale stays f32 through the multiply; the product casts back
        return (y.float() * w["s"].squeeze(-2)).to(x.dtype)
    return torch.matmul(x, w)


def _q4_matmul(x: torch.Tensor, w: dict, out_f32: bool = False) -> torch.Tensor:
    """``x @ W`` against an int4 leaf: per-group partial products in x's
    dtype, then the f32 group-scale contraction."""
    k = x.shape[-1]
    g = w["s"].shape[-2]
    codes = unpack_int4(w["q4"])                       # (K, N) int8
    n = codes.shape[-1]
    xg = x.reshape(*x.shape[:-1], g, k // g)
    qg = codes.reshape(g, k // g, n)
    part = torch.einsum("...gk,gkn->...gn", xg, qg.to(x.dtype))
    y = torch.einsum("...gn,gn->...n", part.float(), w["s"])
    # einsum may hand back permuted strides (it does on the card); the
    # product's callers, the attention kernel among them, take the
    # row-major layout a matmul gives
    return (y if out_f32 else y.to(x.dtype)).contiguous()


def qhead_matmul(x: torch.Tensor, head, dtype: torch.dtype) -> torch.Tensor:
    """lm_head projection to f32 logits for a float, int8 or int4 head:
    the one implementation the decode path uses, so the scale layout
    cannot drift."""
    if is_quantized4_leaf(head):
        return _q4_matmul(x, head, out_f32=True)
    if is_quantized_leaf(head):
        return dot_f32(x, head["q"].to(dtype)) * head["s"].squeeze(-2)
    return dot_f32(x, head.to(dtype))
