"""KV-cache forward and generation for serving.

Port of ``k8s_gpu_device_plugin_tpu/models/generate.py`` for the dense
bf16 layout: ``KVCache``, ``_cache_write``, ``_cached_attention``,
``_project_qkv``, ``_mlp_out``, ``_decode_block``, ``_forward_cached``,
``prefill`` and ``generate``.

Where the reference scans the stacked layers with ``lax.scan`` and
returns a fresh cache, the port loops over layers in Python and writes
the cache IN PLACE: ``_forward_cached`` mutates ``cache`` and returns
only the logits. Every cache read goes through
``ops.attention.serving_cache_attention`` — on the card the hand-written
ragged-paged kernel, for decode (T=1) and every prefill chunk alike; on
the CPU its plain version, which is the reference's gather branch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from k8s_gpu_device_plugin_torch.models.llama import (
    LlamaConfig,
    apply_rope,
    cast_params_for_compute,
    head_weights,
    lm_head_matmul,
    mlp_act,
    rms_norm,
    rope_angles,
)
from k8s_gpu_device_plugin_torch.models.sampling import (
    Sampler,
    init_presence,
    sample_and_mark_dyn,
    sampler_knobs,
)
from k8s_gpu_device_plugin_torch.ops.attention import serving_cache_attention
from k8s_gpu_device_plugin_torch.ops.ragged_paged_attention import (
    ragged_paged_attention_reference,
)


@dataclass
class KVCache:
    """Per-layer stacked K/V at native kv heads: (L, B, max_len, Hkv, hd)
    in ``cfg.dtype``. Slicing the batch axis (``cache.k[:, slot:slot+1]``)
    gives a view, so writes through a slot's view land in the batch."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def init(cfg: LlamaConfig, batch: int, max_len: int,
             device: "str | torch.device") -> "KVCache":
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        )

    def slot(self, slot: int) -> "KVCache":
        """The (L, 1, max_len, Hkv, hd) view of one slot's rows."""
        return KVCache(k=self.k[:, slot:slot + 1], v=self.v[:, slot:slot + 1])


def _cache_write(cache: torch.Tensor, x: torch.Tensor,
                 length: "int | torch.Tensor") -> None:
    """Write T new tokens' K or V, (B, T, Hkv, hd), into one layer's
    cache (B, S, Hkv, hd) at ``length`` — a scalar (every row at one
    position) or a (B,) tensor (every slot at its own position). In
    place."""
    t = x.shape[1]
    x = x.to(cache.dtype)
    if not isinstance(length, torch.Tensor):
        cache[:, length:length + t] = x
        return
    rows = torch.arange(x.shape[0], device=cache.device)[:, None]
    pos = length.long()[:, None] + torch.arange(t, device=cache.device)[None, :]
    cache[rows, pos] = x


def _cached_attention(q, k_cache, v_cache, base, cfg: LlamaConfig,
                      plain: bool = False):
    """q (B, T, Hq, hd) attends its slot's cache rows up to its own
    position: rows are the T new tokens at ``base .. base+T-1``, ``base``
    a (B,) int32 tensor. ``plain=True`` runs the plain version whatever
    the device — the comparison path a card run holds the kernel path
    against; serving never sets it."""
    if plain:
        return ragged_paged_attention_reference(
            q, k_cache, v_cache, base, scale=q.shape[-1] ** -0.5,
            window=cfg.sliding_window,
        )
    return serving_cache_attention(q, k_cache, v_cache, base,
                                   window=cfg.sliding_window)


def _project_qkv(x, layer, rot, cfg: LlamaConfig):
    """Decode-side QKV projection + rope: (B, T, d) -> q (B, T, Hq, hd),
    k and v (B, T, Hkv, hd); ``rot`` is :func:`rope_angles` of the
    tokens' positions."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps, cfg.norm_offset)
    q = h @ layer["wq"]
    k = h @ layer["wk"]
    v = h @ layer["wv"]
    if cfg.attn_bias:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    q = q.reshape(b, t, cfg.n_heads, hd)
    k = k.reshape(b, t, cfg.n_kv_heads, hd)
    v = v.reshape(b, t, cfg.n_kv_heads, hd)
    return apply_rope(q, *rot), apply_rope(k, *rot), v


def _mlp_out(x, layer, cfg: LlamaConfig):
    """The gated-MLP residual branch."""
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps, cfg.norm_offset)
    gate = mlp_act((h @ layer["w1"]).float(), cfg).to(x.dtype)
    up = h @ layer["w3"]
    return (gate * up) @ layer["w2"]


def _decode_block(x, layer, k_cache, v_cache, length, base, rot,
                  cfg: LlamaConfig, plain: bool = False):
    """One transformer block over T new tokens: writes their K/V at
    ``length + arange(T)`` (in place), attends, returns x_out. ``base``
    is ``length`` as a (B,) int32 tensor and ``rot`` the rope angles,
    both built once per forward."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(x, layer, rot, cfg)
    _cache_write(k_cache, k, length)
    _cache_write(v_cache, v, length)
    attn = _cached_attention(q, k_cache, v_cache, base, cfg, plain=plain)
    x = x + attn.reshape(b, t, cfg.n_heads * cfg.head_dim) @ layer["wo"]
    return x + _mlp_out(x, layer, cfg)


def _forward_cached(
    params: dict,
    tokens: torch.Tensor,              # (B, T) int
    cache: KVCache,
    length: "int | torch.Tensor",      # scalar or (B,) first-token position
    cfg: LlamaConfig,
    *,
    last_only: bool = False,
    select_pos: "int | None" = None,
    plain_attention: bool = False,
) -> torch.Tensor:
    """Run T tokens, starting at absolute position ``length``, through
    every layer, writing their K/V into ``cache`` in place. Returns f32
    logits (B, T, V); ``last_only`` projects only the final position and
    ``select_pos`` only that one (a padded prefill chunk whose last real
    token is not its last row). ``plain_attention`` selects the plain
    attention version on any device (see ``_cached_attention``)."""
    params = cast_params_for_compute(params, cfg)
    b, t = tokens.shape
    device = tokens.device
    x = params["embed"][tokens.long()].to(cfg.dtype)
    if cfg.scale_embed:
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=cfg.dtype,
                           device=device)
    steps = torch.arange(t, dtype=torch.int32, device=device)
    if isinstance(length, torch.Tensor):  # per-slot positions (B, T)
        base = length.to(device=device, dtype=torch.int32).contiguous()
        positions = base[:, None] + steps[None, :]
    else:
        base = torch.full((b,), int(length), dtype=torch.int32, device=device)
        positions = int(length) + steps
    rot = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        layer = {name: leaf[i] for name, leaf in layers.items()}
        x = _decode_block(x, layer, cache.k[i], cache.v[i], length, base,
                          rot, cfg, plain=plain_attention)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_offset)
    if last_only:
        x = x[:, -1:]
    elif select_pos is not None:
        x = x[:, select_pos:select_pos + 1]
    return lm_head_matmul(x, head_weights(params, cfg))


def prefill(params, prompt: torch.Tensor, cache: KVCache, cfg: LlamaConfig):
    """Prompt (B, P) -> last-position logits (B, V); fills ``cache``."""
    return _forward_cached(params, prompt, cache, 0, cfg, last_only=True)[:, -1]


def generate(
    params: dict,
    prompt: torch.Tensor,
    cfg: LlamaConfig,
    max_new: int,
    *,
    sampler: "Sampler | None" = None,
    generator: "torch.Generator | None" = None,
) -> torch.Tensor:
    """Greedy (the default) or sampled generation: prompt (B, P) ->
    (B, max_new) generated ids. Prefill over the prompt, then
    ``max_new - 1`` single-token cached forwards (the last token needs
    only a pick from the last logits), as in the reference."""
    sampler = sampler or Sampler()
    b, p = prompt.shape
    device = prompt.device
    cache = KVCache.init(cfg, b, p + max_new, device)
    logits = prefill(params, prompt, cache, cfg)
    knobs = torch.tensor([sampler_knobs(sampler)] * b, dtype=torch.float32,
                         device=device)
    presence = init_presence(prompt, cfg.vocab_size)
    toks = []
    for i in range(max_new):
        tok, presence = sample_and_mark_dyn(logits, knobs, presence, generator)
        toks.append(tok)
        if i + 1 < max_new:
            logits = _forward_cached(params, tok[:, None], cache, p + i,
                                     cfg)[:, -1]
    return torch.stack(toks, dim=1)
