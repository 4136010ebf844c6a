"""Llama-3-family config, parameters and the per-token building blocks.

Port of ``k8s_gpu_device_plugin_tpu/models/llama.py``: the same config
fields and presets (with a torch dtype), the same parameter pytree and
weight layout, and the same numerics contract (bf16 weights and
activations, f32 norm statistics, rope and logits).

Weight layout (identical to the reference, so conversion is a copy):
``params = {"embed": (V, d), "layers": {name: (L, ...)}, "final_norm":
(d,), "lm_head": (d, V)}`` with every layer leaf stacked on a leading
layer axis and every projection stored ``(in, out)`` — ``x @ w``, no
transposes. Layer leaves: ``attn_norm``/``mlp_norm`` (L, d), ``wq``
(L, d, Hq*hd), ``wk``/``wv`` (L, d, Hkv*hd), ``wo`` (L, Hq*hd, d),
``w1``/``w3`` (L, d, d_ff), ``w2`` (L, d_ff, d), plus ``bq``/``bk``/
``bv`` when ``attn_bias``.

The full-sequence forward (``forward_with_aux``/``forward``, the
training path) loops over the stacked layer leaves in Python where the
reference scans them, and wraps each block in ``torch.utils.checkpoint``
when ``remat`` is set; its attention goes through
``ops.attention.attention`` (the flash kernels on the card).

The config refuses the values the port does not serve yet (int8
training matmuls, MoE, tensor, sequence and pipeline parallelism, fused
cross-entropy) instead of ignoring them; each refusal names its ROADMAP
item. Weight-only quantized serving params (``models/quantized_serving.py``)
are dict leaves in the same tree: the master-weight cast passes them
through and ``head_weights`` returns a quantized head as it is.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from k8s_gpu_device_plugin_torch.device import resolve_device
from k8s_gpu_device_plugin_torch.models.quantized_serving import (
    check_cache_quant_kv_layout,
)
from k8s_gpu_device_plugin_torch.ops.attention import attention
from k8s_gpu_device_plugin_torch.ops.quant import dot_f32

REMAT_POLICIES = ("save_dots_attn", "save_dots", "save_nothing")


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq: int = 8192
    # Mistral-style sliding window (0 = full causal): query i attends
    # keys in (i - window, i]
    sliding_window: int = 0
    # Qwen2-style q/k/v projection biases
    attn_bias: bool = False
    # Gemma-family dials (defaults = Llama behaviour)
    act: str = "silu"          # "silu" | "gelu_tanh"
    norm_offset: bool = False  # RMSNorm scales by (1 + w)
    tied_embeddings: bool = False
    scale_embed: bool = False
    head_dim_override: int = 0
    dtype: torch.dtype = torch.bfloat16
    # parameter storage dtype (None = ``dtype``)
    param_dtype: "torch.dtype | None" = None
    # training: block rematerialization and what it saves (read only when
    # remat): "save_dots_attn" keeps the projection/MLP matmul outputs and
    # the flash attention output, "save_dots" the matmul outputs only,
    # "save_nothing" nothing (numerics are the same under every policy)
    remat: bool = True
    remat_policy: str = "save_dots_attn"
    # the reference's dials the port serves only at their defaults; "auto"
    # is single-device attention here (the reference's "full" at sp=1)
    attn_impl: str = "auto"
    # pipeline-parallel microbatches (the reference reads it only at pp > 1)
    n_microbatches: int = 1
    fused_ce: bool = False
    quant: str = "none"
    # KV-cache storage for serving (models/generate.py): "int8" keeps K/V
    # as codes with one f32 scale per (position, kv head), dequantized in
    # the attention kernel; "int4" the same with int4 codes packed two
    # per byte (ops/quant.py)
    cache_quant: str = "none"
    # serving KV layout (models/batching.py): "dense" reserves max_len
    # rows per slot; "paged" maps slots onto a shared pool of
    # kv_page_size-row pages through per-slot page tables
    # (models/paging.py). Scale planes ride the same page geometry.
    kv_layout: str = "dense"
    # token rows per page when kv_layout == "paged": must divide the
    # batcher's max_len; the kernel takes a power of two >= 8
    kv_page_size: int = 64
    tp: int = 1
    n_experts: int = 0

    def __post_init__(self) -> None:
        if self.act not in ("silu", "gelu_tanh"):
            raise ValueError(
                f"act must be 'silu' or 'gelu_tanh', got {self.act!r}"
            )
        if self.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(
                f"dtype must be torch.bfloat16 or torch.float32, got "
                f"{self.dtype}"
            )
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy must be one of {REMAT_POLICIES}, got "
                f"{self.remat_policy!r}"
            )
        if self.attn_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r}: sequence-parallel attention "
                "is not ported yet (ROADMAP A12); use 'auto'"
            )
        if self.attn_impl != "auto":
            raise ValueError(
                f"attn_impl={self.attn_impl!r}: the port has one "
                "single-device attention, 'auto' (the reference's 'full' "
                "without sequence parallelism)"
            )
        check_cache_quant_kv_layout(self)
        if self.kv_page_size < 1:
            raise ValueError(
                f"kv_page_size must be >= 1, got {self.kv_page_size}"
            )
        refusals = (
            ("quant", "none", "int8 training matmuls are not ported yet "
             "(ROADMAP A8); use quant='none' (weight-only serving "
             "quantization is models/quantized_serving.py)"),
            ("n_experts", 0, "MoE MLPs are not ported yet (ROADMAP A10); "
             "use a dense config (n_experts=0)"),
            ("tp", 1, "tensor-parallel serving is not ported yet (ROADMAP "
             "A11); serve tp=1 (one card)"),
            ("fused_ce", False, "fused lm_head + cross-entropy is not "
             "ported yet (ROADMAP A8); use fused_ce=False"),
            ("n_microbatches", 1, "pipeline parallelism is not ported yet "
             "(ROADMAP A12); use n_microbatches=1"),
        )
        for name, allowed, why in refusals:
            if getattr(self, name) != allowed:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r}: {why}"
                )

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def p_dtype(self) -> torch.dtype:
        return self.param_dtype if self.param_dtype is not None else self.dtype

    # --- presets (the reference's, dims unchanged) ---

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, rope_theta=500000.0, max_seq=8192,
        )

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, d_model=8192, n_layers=80, n_heads=64,
            n_kv_heads=8, d_ff=28672, rope_theta=500000.0, max_seq=8192,
        )

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, rope_theta=10000.0, max_seq=32768,
            sliding_window=4096,
        )

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        cfg = LlamaConfig(
            vocab_size=512, d_model=128, n_layers=2, n_heads=8,
            n_kv_heads=4, d_ff=256, max_seq=256, rope_theta=10000.0,
        )
        return replace(cfg, **overrides)

    def flops_per_token(self) -> float:
        """Dense training FLOPs/token: 6 * matmul params (fwd+bwd). The
        O(S) attention-score FLOPs are left out (standard 6N model-FLOPs
        accounting), so an MFU from it is slightly conservative."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.head_dim
        attn_proj = 2 * d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
        mlp = 3 * d * f
        embed = self.vocab_size * d  # lm_head (the embed table is a gather)
        return 6.0 * (L * (attn_proj + mlp) + embed)


def init_params(cfg: LlamaConfig, *, seed: int = 0,
                device: "str | torch.device | None" = "cuda") -> dict:
    """Random parameters in the reference's layout and distribution
    (truncated normal, std 0.02; output projections 0.02/sqrt(2L)),
    drawn ON ``device`` from an explicit ``torch.Generator`` seeded with
    ``seed``. The draws differ from JAX's (another generator), so tests
    that compare the two frameworks convert JAX's parameters instead
    (models/convert.py)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    std = 0.02
    out_std = std / math.sqrt(2 * L)

    def normal(shape, scale):
        # drawn in f32 (precision of the tail clamp), stored in p_dtype
        x = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(x, 0.0, scale, -3 * scale, 3 * scale,
                                    generator=gen)
        return x.to(cfg.p_dtype)

    def norm_weight(shape):
        fill = torch.zeros if cfg.norm_offset else torch.ones
        return fill(shape, dtype=cfg.p_dtype, device=dev)

    layers = {
        "attn_norm": norm_weight((L, d)),
        "mlp_norm": norm_weight((L, d)),
        "wq": normal((L, d, cfg.n_heads * hd), std),
        "wk": normal((L, d, cfg.n_kv_heads * hd), std),
        "wv": normal((L, d, cfg.n_kv_heads * hd), std),
        "wo": normal((L, cfg.n_heads * hd, d), out_std),
    }
    if cfg.attn_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            layers[name] = torch.zeros((L, width * hd), dtype=cfg.p_dtype,
                                       device=dev)
    layers["w1"] = normal((L, d, cfg.d_ff), std)
    layers["w3"] = normal((L, d, cfg.d_ff), std)
    layers["w2"] = normal((L, cfg.d_ff, d), out_std)
    params = {
        "embed": normal((cfg.vocab_size, d), std),
        "layers": layers,
        "final_norm": norm_weight((d,)),
    }
    if not cfg.tied_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), std)
    return params


def cast_params_for_compute(params: dict, cfg: LlamaConfig) -> dict:
    """Master-weight cast: layer stacks -> compute dtype (no-op, and the
    same dict back, when storage == compute dtype). Quantized serving
    leaves (``{"q", "s"}``/``{"q4", "s"}`` dicts) pass through untouched:
    casting them would destroy the quantization."""
    if cfg.p_dtype == cfg.dtype:
        return params
    return {
        **params,
        "layers": {k: v if isinstance(v, dict) else v.to(cfg.dtype)
                   for k, v in params["layers"].items()},
    }


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: bool = False) -> torch.Tensor:
    """RMSNorm with f32 statistics; ``offset`` scales by (1 + w)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if offset:
        w = 1.0 + w
    return (normed * w).to(x.dtype)


def mlp_act(x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """The gated-MLP activation: Llama silu or Gemma tanh-approx gelu."""
    if cfg.act == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def head_weights(params: dict, cfg: LlamaConfig) -> "torch.Tensor | dict":
    """The (d, V) lm_head operand: the dedicated leaf (a quantized
    serving head is returned as its leaf dict), else the transposed
    embedding table for tied-embedding configs."""
    if "lm_head" in params:
        return params["lm_head"]
    if cfg.tied_embeddings:
        return params["embed"].T
    raise KeyError("params has no lm_head and cfg is not tied_embeddings")


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles for integer positions (S,) or
    per-row positions (B, S), shaped to broadcast over (B, S, H, D/2).
    Angles in f32. A forward computes them once and every layer's q and
    k reuse them."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    # a Python-number base: no host-to-device copy, so no stream sync
    freqs = torch.pow(float(theta), exponent)
    angles = positions[..., None].float() * freqs          # (..., S, D/2)
    if positions.dim() == 1:
        return angles.cos()[None, :, None, :], angles.sin()[None, :, None, :]
    return angles.cos()[:, :, None, :], angles.sin()[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of (B, S, H, D) by :func:`rope_angles`."""
    x1, x2 = x.float().split(x.shape[-1] // 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over (B, S, H, D) with integer positions (S,) or
    per-row positions (B, S) (continuous batching: every slot at its own
    absolute position)."""
    return apply_rope(x, *rope_angles(positions, x.shape[-1], theta))


# --- the full-sequence forward (training) -------------------------------------


def _matmul_f32_acc(a: torch.Tensor, b: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """a @ b from ``a.dtype`` operands with f32 accumulation, rounded once
    to ``out_dtype``. cuBLAS accumulates bf16 products in f32 and rounds
    at the output; the CPU widens the operands (exact bf16 -> f32)."""
    if a.dtype == torch.float32 or a.device.type == "cuda":
        return (a @ b).to(out_dtype)
    return (a.float() @ b.float()).to(out_dtype)


class _LMHead(torch.autograd.Function):
    """The lm_head product (``ops.quant.dot_f32``: f32 logits from
    operands in x's dtype) with the reference's custom backward
    (``ops/quant.py::bf16_ste_bwd``): the f32 logits cotangent is cast to
    the operands' dtype, then dx and dw are f32-accumulated products
    rounded to x's and w's dtypes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return dot_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gb = g.to(x.dtype)
        dx = _matmul_f32_acc(gb, w.to(x.dtype).T, x.dtype)
        d = x.shape[-1]
        dw = _matmul_f32_acc(x.reshape(-1, d).T, gb.reshape(-1, gb.shape[-1]),
                             w.dtype)
        return dx, dw


def _remat_context_fn(policy: str):
    """The selective-checkpoint policy of ``remat_policy`` (the
    reference's ``save_from_both_policies``): matmul outputs without
    batch dims (``aten.mm``, every projection and MLP product) are saved,
    plus, under "save_dots_attn", the flash attention custom op's outputs;
    everything else is recomputed. On the CPU the attention runs
    ``mha_reference``, which has no op to save, and is recomputed."""
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
    )

    saved = {torch.ops.aten.mm.default}
    if policy == "save_dots_attn":
        saved.add(torch.ops.k8s_gpu_device_plugin_torch.flash_attention.default)

    def policy_fn(ctx, op, *args, **kwargs):
        if op in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def _attention(q, k, v, cfg: LlamaConfig, plain: bool = False):
    """Single-device full causal attention (``attn_impl="auto"``; the
    config refuses the others)."""
    return attention(q, k, v, causal=True, window=cfg.sliding_window,
                     plain=plain)


def _block(x, layer, cfg: LlamaConfig, rot, plain_attention: bool = False):
    """One transformer block: (B, S, D) -> (B, S, D). ``rot`` is
    :func:`rope_angles` of the positions, built once per forward."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps, cfg.norm_offset)
    q, k, v = h @ layer["wq"], h @ layer["wk"], h @ layer["wv"]
    if cfg.attn_bias:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    q = apply_rope(q.reshape(b, s, cfg.n_heads, hd), *rot)
    k = apply_rope(k.reshape(b, s, cfg.n_kv_heads, hd), *rot)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    attn = _attention(q, k, v, cfg, plain=plain_attention)
    x = x + attn.reshape(b, s, cfg.n_heads * hd) @ layer["wo"]
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps, cfg.norm_offset)
    gate = mlp_act((h @ layer["w1"]).float(), cfg).to(x.dtype)
    up = h @ layer["w3"]
    return x + (gate * up) @ layer["w2"]


def forward_with_aux(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
                     return_hidden: bool = False,
                     plain_attention: bool = False) -> tuple:
    """Token ids (B, S) -> (logits (B, S, V) f32, aux losses). Dense
    configs have no aux losses, so aux is ``{}``. ``return_hidden`` stops
    before the lm_head and returns the final normed hidden states
    (B, S, D). ``plain_attention`` runs ``mha_reference`` on any device
    (see ``ops.attention.attention``)."""
    from torch.utils.checkpoint import checkpoint

    params = cast_params_for_compute(params, cfg)
    b, s = tokens.shape
    x = params["embed"].to(cfg.dtype)[tokens]
    if cfg.scale_embed:
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=cfg.dtype,
                           device=x.device)
    rot = rope_angles(torch.arange(s, device=tokens.device), cfg.head_dim,
                      cfg.rope_theta)
    block = functools.partial(_block, cfg=cfg, rot=rot,
                              plain_attention=plain_attention)
    context_fn = None
    if cfg.remat and cfg.remat_policy != "save_nothing":
        context_fn = _remat_context_fn(cfg.remat_policy)
    # one unbind per leaf: its backward stacks the L layer grads once,
    # where per-layer indexing would scatter each into a full-size zero
    layers = {name: leaf.unbind(0) for name, leaf in params["layers"].items()}
    for i in range(cfg.n_layers):
        layer = {name: leaves[i] for name, leaves in layers.items()}
        if not cfg.remat:
            x = block(x, layer)
        elif context_fn is None:
            x = checkpoint(block, x, layer, use_reentrant=False)
        else:
            x = checkpoint(block, x, layer, use_reentrant=False,
                           context_fn=context_fn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_offset)
    if return_hidden:
        return x, {}
    return _LMHead.apply(x, head_weights(params, cfg).to(cfg.dtype)), {}


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
            plain_attention: bool = False) -> torch.Tensor:
    """Token ids (B, S) -> logits (B, S, V) in f32."""
    return forward_with_aux(params, tokens, cfg,
                            plain_attention=plain_attention)[0]
