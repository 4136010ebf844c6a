"""Parameter and KV-cache conversion between the JAX reference and the
port.

The two packages share one weight layout (models/llama.py states it):
stacked ``layers`` leaves with a leading layer axis, projections stored
``(in, out)``, ``embed`` (V, d), ``final_norm`` (d,), ``lm_head`` (d, V).
So conversion is a per-leaf copy with no transposes — the parity tests
feed both frameworks the same numbers. A KV cache converts the same way
(:func:`kv_cache_from_jax`): both packages keep one geometry per layout,
so tests can start both from one cache. LoRA factors convert the same
way: an attached AdapterSet's stacks ride ``params_from_jax``, a single
adapter's factor tree :func:`lora_params_from_jax`.

A MoE tree's ``router`` (L, d, E) stays f32 whatever the storage dtype
(rounding it would move top-k decisions); its expert stacks (L, E, in,
out), float or quantized, convert like any other layer leaf.

Quantized leaves keep their own dtypes: the reference's weight-only
``{"q": int8, "s": f32}`` and ``{"q4": int4, "s": f32}`` leaves, and its
int8/int4 caches. ``jnp.int4`` arrives as an ml_dtypes int4 array; it is
widened to int8 and packed two codes per byte (``ops/quant.py``), the
port's storage of int4 codes.

HuggingFace checkpoints (port of the reference's HF import): a
``LlamaForCausalLM``-layout state dict (Llama, Mistral, Qwen2, Gemma)
converts through :func:`config_from_hf` and :func:`params_from_hf`, and
back through :func:`params_to_hf`. torch ``Linear.weight`` is (out, in),
so every projection is transposed; per-layer tensors stack on the
leading layer axis. The HF config is read by attribute, so an in-memory
``transformers`` config or any object with the same attributes serves;
this module never imports ``transformers``, and nothing is downloaded.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from k8s_gpu_device_plugin_torch.device import resolve_device
from k8s_gpu_device_plugin_torch.models.generate import KVCache
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig
from k8s_gpu_device_plugin_torch.models.lora import target_dims
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
            name: _leaf(leaf, _layer_dtype(name, cfg), dev)
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
    dims = target_dims(cfg)
    for name, leaf in out["layers"].items():
        if not name.startswith("lora_"):
            continue
        t, side = name[len("lora_"):-2], name[-1]
        if t not in dims or name[-2] != "_" or side not in "ab" \
                or leaf.ndim != 4 or leaf.shape[0] != cfg.n_layers \
                or leaf.shape[2 if side == "a" else 3] != dims[t][
                    0 if side == "a" else 1]:
            raise ValueError(
                f"layers.{name} is {tuple(leaf.shape)}: not a LoRA stack "
                f"of {cfg.n_layers} layers for this config")
    L, f = cfg.n_layers, cfg.d_ff
    want = {"wq": (L, d, cfg.n_heads * hd)}
    if cfg.is_moe:
        e = cfg.n_experts
        want.update(router=(L, d, e), moe_w1=(L, e, d, f),
                    moe_w3=(L, e, d, f), moe_w2=(L, e, f, d))
    for name, shape in want.items():
        got = _logical_shape(out["layers"][name]) \
            if name in out["layers"] else None
        if got != shape:
            raise ValueError(f"layers.{name} is {got}, cfg wants {shape}")
    return out


def _layer_dtype(name: str, cfg: LlamaConfig) -> torch.dtype:
    """A layer leaf's dtype in the port: an attached AdapterSet's
    ``lora_{t}_{a,b}`` stacks are factors, kept in the compute dtype as
    the reference keeps them; the MoE router is f32; every other leaf is
    a weight in the storage dtype."""
    if name.startswith("lora_"):
        return cfg.dtype
    if name == "router":
        return torch.float32
    return cfg.p_dtype


def lora_params_from_jax(np_lora: dict, cfg: LlamaConfig,
                         device: "str | torch.device | None" = "cuda"
                         ) -> dict:
    """A reference adapter's factors as numpy arrays, ``{target: {"a":
    (L, in, r), "b": (L, r, out)}}`` (reference ``models/lora.py``), ->
    the port's on ``device`` in ``cfg.dtype``: both packages then serve
    the same adapter. Refuses a target or a shape that does not fit
    ``cfg``."""
    dev = resolve_device(device)
    dims = target_dims(cfg)
    out = {}
    for t, ab in np_lora.items():
        if t not in dims or set(ab) != {"a", "b"}:
            raise ValueError(f"not a LoRA factor pair for this config: {t!r}")
        a = _tensor(ab["a"], cfg.dtype, dev)
        b = _tensor(ab["b"], cfg.dtype, dev)
        d_in, d_out = dims[t]
        r = a.shape[-1]
        if a.shape != (cfg.n_layers, d_in, r) or \
                b.shape != (cfg.n_layers, r, d_out):
            raise ValueError(
                f"{t}: a {tuple(a.shape)}, b {tuple(b.shape)}; cfg wants "
                f"({cfg.n_layers}, {d_in}, r) and ({cfg.n_layers}, r, "
                f"{d_out})")
        out[t] = {"a": a, "b": b}
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


# --- HuggingFace checkpoints --------------------------------------------------


def config_from_hf(hf_config: Any,
                   dtype: torch.dtype = torch.bfloat16) -> LlamaConfig:
    """Map an HF Llama / Mistral / Qwen2 / Gemma config onto
    :class:`LlamaConfig`. Refuses what the port would compute wrongly:
    ``rope_scaling`` (the port computes plain rotary frequencies from
    ``rope_theta``), an activation other than silu or tanh-gelu, and a
    layer-partial Qwen2 window (:func:`_window_from_hf`)."""
    model_type = getattr(hf_config, "model_type", "llama")
    # tied embeddings for any family (head_weights serves embed.T);
    # params_from_hf checks that the materialized head equals the table
    tied = bool(getattr(hf_config, "tie_word_embeddings", False))
    scaling = getattr(hf_config, "rope_scaling", None)
    if scaling:
        raise NotImplementedError(
            f"rope_scaling {scaling!r} not supported: this stack computes "
            "plain rotary frequencies from rope_theta"
        )
    act = (getattr(hf_config, "hidden_activation", None)
           or getattr(hf_config, "hidden_act", "silu"))
    if act in ("silu", "swish"):
        our_act = "silu"
    elif act in ("gelu_pytorch_tanh", "gelu_tanh"):
        our_act = "gelu_tanh"
    else:
        raise NotImplementedError(
            f"hidden_act {act!r} not supported (silu or tanh-gelu only)"
        )
    # Qwen2: the Llama layout plus q/k/v biases. HF Llama's attention_bias
    # also biases o_proj, which the port has no leaf for: params_from_hf
    # refuses it as an unconsumed tensor.
    attn_bias = model_type == "qwen2" or bool(
        getattr(hf_config, "attention_bias", False))
    gemma = model_type == "gemma"
    hd = int(getattr(hf_config, "head_dim", 0) or 0)
    default_hd = hf_config.hidden_size // hf_config.num_attention_heads
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        d_ff=hf_config.intermediate_size,
        rope_theta=float(hf_config.rope_theta),
        norm_eps=float(hf_config.rms_norm_eps),
        max_seq=int(getattr(hf_config, "max_position_embeddings", 8192)),
        # a Mistral checkpoint was trained windowed: keep its window
        sliding_window=_window_from_hf(hf_config),
        attn_bias=attn_bias,
        # Gemma: GeGLU, (1 + w) norms, tied head, sqrt(d)-scaled
        # embeddings and an explicit head dim
        act=our_act,
        norm_offset=gemma,
        tied_embeddings=tied,
        scale_embed=gemma,
        head_dim_override=hd if hd and hd != default_hd else 0,
        dtype=dtype,
    )


def _window_from_hf(hf_config: Any) -> int:
    """The sliding window, with Qwen2's gating: its checkpoints ship
    ``sliding_window`` but apply it only with ``use_sliding_window``, and
    then only to layers at or past ``max_window_layers``. So a
    ``max_window_layers`` of at least the depth windows no layer, 0 every
    layer, and anything between is layer-partial, which one window for
    every layer cannot express: refused."""
    window = int(getattr(hf_config, "sliding_window", None) or 0)
    if not getattr(hf_config, "use_sliding_window", True):
        return 0
    mwl = getattr(hf_config, "max_window_layers", None)
    if window and mwl is not None:
        if mwl >= hf_config.num_hidden_layers:
            return 0
        if mwl > 0:
            raise NotImplementedError(
                f"layer-partial sliding window (layers >= "
                f"max_window_layers={mwl} of {hf_config.num_hidden_layers} "
                "windowed) not supported: this stack applies one window to "
                "every layer"
            )
    return window


#: per-layer tensors, both directions: ours -> (HF name suffix, transpose?)
_LAYER_MAP = {
    "attn_norm": ("input_layernorm.weight", False),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "w1": ("mlp.gate_proj.weight", True),
    "w3": ("mlp.up_proj.weight", True),
    "w2": ("mlp.down_proj.weight", True),
}

#: Qwen2's q/k/v biases, taken only when ``cfg.attn_bias``
_BIAS_MAP = {
    "bq": ("self_attn.q_proj.bias", False),
    "bk": ("self_attn.k_proj.bias", False),
    "bv": ("self_attn.v_proj.bias", False),
}


def _layer_map(cfg: LlamaConfig) -> dict:
    return {**_LAYER_MAP, **_BIAS_MAP} if cfg.attn_bias else _LAYER_MAP


def _hf_f32(t, device: torch.device) -> torch.Tensor:
    """A checkpoint tensor (torch or numpy) in f32 on ``device``."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(t, np.float32)).to(device)


def params_from_hf(state_dict: Mapping[str, Any], cfg: LlamaConfig,
                   device: "str | torch.device | None" = "cuda") -> dict:
    """An HF ``LlamaForCausalLM``-layout state dict (torch tensors or
    numpy arrays) -> the port's params on ``device`` in ``cfg.p_dtype``
    (each tensor read in f32, transposed and stacked on ``device``, then
    rounded once). Raises KeyError on a missing weight and ValueError on
    a shape that does not match ``cfg``, a tied head that differs from
    the embedding, or a tensor left unconsumed (Llama's ``o_proj`` bias,
    for one)."""
    dev = resolve_device(device)
    sd = dict(state_dict)

    def take(name: str, transpose: bool = False) -> torch.Tensor:
        w = _hf_f32(sd.pop(name), dev)
        return w.T if transpose else w

    def stack(fmt: str, transpose: bool = False) -> torch.Tensor:
        return torch.stack([take(fmt.format(i), transpose).to(cfg.p_dtype)
                            for i in range(cfg.n_layers)])

    embed = take("model.embed_tokens.weight")
    params = {
        "embed": embed.to(cfg.p_dtype),
        "layers": {
            ours: stack("model.layers.{}." + suffix, transpose)
            for ours, (suffix, transpose) in _layer_map(cfg).items()
        },
        "final_norm": take("model.norm.weight").to(cfg.p_dtype),
    }
    if cfg.tied_embeddings:
        # the state dict materializes the tied head: consume it, and refuse
        # a "tied" head that diverged from the table (an untied fine-tune)
        head = sd.pop("lm_head.weight", None)
        if head is not None and not torch.equal(_hf_f32(head, dev), embed):
            raise ValueError(
                "config claims tied embeddings but lm_head.weight differs "
                "from embed_tokens.weight: convert as untied instead"
            )
    else:
        params["lm_head"] = take("lm_head.weight", True).to(cfg.p_dtype)
    del embed
    expected = {"embed": (cfg.vocab_size, cfg.d_model)}
    if not cfg.tied_embeddings:
        expected["lm_head"] = (cfg.d_model, cfg.vocab_size)
    for name, shape in expected.items():
        if tuple(params[name].shape) != shape:
            raise ValueError(
                f"{name}: checkpoint shape {tuple(params[name].shape)} != "
                f"config shape {shape}"
            )
    want = (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)
    if tuple(params["layers"]["wq"].shape) != want:
        raise ValueError(
            f"wq: checkpoint shape {tuple(params['layers']['wq'].shape)} "
            f"incompatible with config {cfg}"
        )
    # rotary_emb.inv_freq buffers are derived, not parameters
    leftover = [k for k in sd if "rotary_emb" not in k]
    if leftover:
        raise ValueError(f"unconsumed checkpoint tensors: {leftover[:5]}")
    return params


def params_to_hf(params: dict, cfg: LlamaConfig) -> dict:
    """The port's params -> an HF ``LlamaForCausalLM``-layout state dict
    of contiguous f32 CPU tensors (``load_state_dict`` takes it as it is;
    transposes made contiguous, as serializers need). The inverse of
    :func:`params_from_hf`. Refuses a MoE tree, a weight-quantized leaf
    and a tree whose depth is not ``cfg.n_layers``."""
    if "router" in params["layers"]:
        raise NotImplementedError(
            "MoE pytrees have no LlamaForCausalLM equivalent"
        )

    def f32(x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        x = x.detach().float()  # transposed on x's device: one copy out
        return (x.T if transpose else x).contiguous().cpu()

    leaves = [params["embed"], params["final_norm"], params.get("lm_head"),
              *params["layers"].values()]
    if any(isinstance(x, dict) for x in leaves):
        raise NotImplementedError(
            "weight-quantized leaves have no LlamaForCausalLM equivalent"
        )

    sd = {
        "model.embed_tokens.weight": f32(params["embed"]),
        "model.norm.weight": f32(params["final_norm"]),
    }
    if "lm_head" in params:
        sd["lm_head.weight"] = f32(params["lm_head"], True)
    for ours, (theirs, transpose) in _layer_map(cfg).items():
        stacked = params["layers"][ours]
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(
                f"{ours}: params have {stacked.shape[0]} stacked layers but "
                f"the config says n_layers={cfg.n_layers}: a mismatched "
                "config would silently truncate the exported checkpoint"
            )
        for i in range(cfg.n_layers):
            sd[f"model.layers.{i}.{theirs}"] = f32(stacked[i], transpose)
    return sd
