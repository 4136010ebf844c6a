"""Bounded-memory decode for sliding-window models: a ring KV cache.

Port of ``k8s_gpu_device_plugin_tpu/models/rolling.py``. With window W,
position p only ever serves queries in [p, p + W), so the cache needs
exactly W slots: token p lives at slot ``p % W`` and is overwritten the
step it leaves every future query's window. Decode memory is O(W)
regardless of how many tokens are generated — the practical Mistral
serving property (a 32k-token generation holds a 4k cache).

Slot positions are a pure function of (length, slot)
(``p_s = L - 1 - ((L - 1 - s) mod W)``), so nothing tracks them — the
attention mask recomputes them from the length each step, and every write
lands at ``p % W``. Prefill runs through the ordinary cache at prompt
size (``_forward_cached(last_only=True)``: on the card the ragged-paged
kernel's chunk route, with the window), then the last ``min(P, W)``
roped K/V rows roll into the ring. The ring attention is plain ``torch``,
as the reference's is plain XLA: the kernel reads a linear cache, not a
rotated ring.

Pinned by tests: ``rolling_generate`` token-exact (f32) against the
unbounded windowed ``generate`` across p < W, p > W, and generations
that wrap the ring several times, on bf16/f32, int8 and int4 rings.
"""

from __future__ import annotations

import math

import torch

from k8s_gpu_device_plugin_torch.models.generate import (
    KVCache,
    _cache_write,
    _forward_cached,
    _mlp_out,
    _project_qkv,
)
from k8s_gpu_device_plugin_torch.models.llama import (
    LlamaConfig,
    cast_params_for_compute,
    head_weights,
    rms_norm,
    rope_angles,
)
from k8s_gpu_device_plugin_torch.models.quantized_serving import (
    layer_slice,
    qhead_matmul,
    qmatmul,
)
from k8s_gpu_device_plugin_torch.models.sampling import (
    Sampler,
    init_presence,
    sample_and_mark_dyn,
    sampler_knobs,
)
from k8s_gpu_device_plugin_torch.ops.quant import unpack_int4


def _ring_from_prefill(cache_kv: torch.Tensor, p: int, w: int) -> torch.Tensor:
    """(L, B, P, ...) prefill rows -> (L, B, W, ...) ring.

    Keeps the last m = min(P, W) positions; position q lands at slot
    q % W. For P < W the tail slots stay zero (masked by position math);
    for P >= W the W consecutive positions are a rotation of the slots.
    Shape-generic over the trailing dims (codes, packed codes, scales)."""
    if p < w:
        pad = torch.zeros((*cache_kv.shape[:2], w - p, *cache_kv.shape[3:]),
                          dtype=cache_kv.dtype, device=cache_kv.device)
        return torch.cat([cache_kv, pad], dim=2)
    last = cache_kv[:, :, p - w:p]
    return torch.roll(last, shifts=(p - w) % w, dims=2)


def _ring_f32(ring: torch.Tensor) -> torch.Tensor:
    """A ring's rows in f32, exactly: codes as they are (packed int4
    unpacked first), bf16/f32 rows widened."""
    if ring.dtype == torch.uint8:
        ring = unpack_int4(ring)
    return ring.float()


def _ring_attention_step(q, ring_k, ring_v, k_scale, v_scale, length: int,
                         cfg: LlamaConfig):
    """T=1 attention over the ring AFTER the current token's K/V landed.

    q: (B, 1, Hq, hd); ring: (B, W, Hkv, hd) (packed int4: hd / 2).
    ``length`` counts tokens written so far INCLUDING the current one (the
    query sits at position length - 1). Slot s holds position
    L-1 - ((L-1-s) mod W); negatives are unwritten slots. The window mask
    is implied: every live slot is within W of the query by construction.

    The products take q's dtype operands (the rows and codes exactly, the
    probs rounded to q's dtype) with f32 accumulation, as the reference's
    ``preferred_element_type=f32``. Quantized rings (``k_scale``/
    ``v_scale`` (B, W, Hkv, 1), None on an unquantized ring) follow the
    reference: the per-(slot, head) scales apply to scores after the K
    contraction and to probs before the V contraction."""
    b, _, hq, hd = q.shape
    w = ring_k.shape[1]
    group = hq // cfg.n_kv_heads
    qg = q.reshape(b, 1, cfg.n_kv_heads, group, hd)
    scores = torch.einsum("btkgd,bskd->btkgs", qg.float(),
                          _ring_f32(ring_k)) * (hd ** -0.5)
    if k_scale is not None:
        ks = k_scale[..., 0].transpose(1, 2)            # (B, Hkv, W)
        scores = scores * ks[:, None, :, None, :]
    last = length - 1
    s_idx = torch.arange(w, device=q.device)
    slot_pos = last - ((last - s_idx) % w)              # (W,)
    keep = slot_pos >= 0
    scores = torch.where(keep[None, None, None, None, :], scores,
                         torch.full((), -1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        vs = v_scale[..., 0].transpose(1, 2)            # (B, Hkv, W)
        probs = probs * vs[:, None, :, None, :]
    out = torch.einsum("btkgs,bskd->btkgd", probs.to(q.dtype).float(),
                       _ring_f32(ring_v))
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def _ring_decode_block(x, layer, ring: tuple, pos: int, cfg: LlamaConfig):
    """One block over ONE new token at absolute position ``pos``; writes
    its K/V at slot pos % W (in place), then attends the ring. ``ring``
    is the layer's (k, v, k_scale, v_scale). Projection/rope and the MLP
    branch are the SAME helpers the linear-cache block uses
    (generate._project_qkv/_mlp_out), and quantized rings (int8, packed
    int4) write through generate's ``_cache_write``, so the two paths
    cannot drift."""
    b, t, _ = x.shape
    ring_k, ring_v, rk_s, rv_s = ring
    w = ring_k.shape[1]
    positions = pos + torch.arange(t, dtype=torch.int32, device=x.device)
    rot = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q, k, v = _project_qkv(x, layer, rot, cfg)
    slot = pos % w
    _cache_write(ring_k, rk_s, k, slot)
    _cache_write(ring_v, rv_s, v, slot)
    attn = _ring_attention_step(q, ring_k, ring_v, rk_s, rv_s, pos + 1, cfg)
    x = x + qmatmul(attn.reshape(b, t, cfg.n_heads * cfg.head_dim),
                    layer["wo"])
    return x + _mlp_out(x, layer, cfg)


def _ring_forward(params, tok: torch.Tensor, ring: KVCache, pos: int,
                  cfg: LlamaConfig) -> torch.Tensor:
    """One token (B,) through all layers against the ring (written in
    place); returns (B, V) f32 logits."""
    params = cast_params_for_compute(params, cfg)
    x = params["embed"][tok.long()[:, None]].to(cfg.dtype)
    if cfg.scale_embed:
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=cfg.dtype,
                           device=x.device)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        layer = {name: layer_slice(leaf, i) for name, leaf in layers.items()}
        x = _ring_decode_block(x, layer, ring.layer(i), pos, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_offset)
    return qhead_matmul(x[:, -1], head_weights(params, cfg), cfg.dtype)


def rolling_generate(
    params: dict,
    prompt: torch.Tensor,
    cfg: LlamaConfig,
    max_new: int,
    *,
    sampler: "Sampler | None" = None,
    generator: "torch.Generator | None" = None,
) -> torch.Tensor:
    """Windowed generation with an O(window) ring cache: prompt (B, P) ->
    (B, max_new) ids.

    Same contract as ``generate`` (greedy by default, ``Sampler`` with an
    explicit ``generator`` for sampling) for configs with
    ``sliding_window > 0``; the cache never grows past the window no
    matter how long the generation runs. Runs where ``prompt`` and
    ``params`` live.
    """
    if cfg.sliding_window <= 0:
        raise ValueError(
            "rolling_generate needs cfg.sliding_window > 0 (full-causal "
            "models need every past position: use generate)"
        )
    b, p = prompt.shape
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    w = cfg.sliding_window
    sampler = sampler or Sampler()
    device = prompt.device

    # prefill at prompt size (activations are O(P) regardless), then keep
    # only the live window in the ring; scale planes (int8/int4 caches)
    # roll identically to the K/V codes
    pre_cache = KVCache.init(cfg, b, p, device)
    logits = _forward_cached(params, prompt, pre_cache, 0, cfg,
                             last_only=True)[:, -1]

    def roll(x):
        return None if x is None else _ring_from_prefill(x, p, w)

    ring = KVCache(k=roll(pre_cache.k), v=roll(pre_cache.v),
                   k_scale=roll(pre_cache.k_scale),
                   v_scale=roll(pre_cache.v_scale))
    del pre_cache

    knobs = torch.tensor([sampler_knobs(sampler)] * b, dtype=torch.float32,
                         device=device)
    presence = init_presence(prompt, cfg.vocab_size)
    toks = []
    for i in range(max_new):
        tok, presence = sample_and_mark_dyn(logits, knobs, presence, generator)
        toks.append(tok)
        if i + 1 < max_new:
            logits = _ring_forward(params, tok, ring, p + i, cfg)
    return torch.stack(toks, dim=1)
