"""KV-cache forward and generation for serving.

Port of ``k8s_gpu_device_plugin_tpu/models/generate.py``: ``KVCache``
(dense or a paged pool; bf16/f32, or int8 or packed int4 codes with f32
scale planes), ``_quantize_kv``, ``_cache_write``, ``_cached_attention``,
``_qm_lora``, ``_project_qkv``, ``_decode_moe_mlp``, ``_mlp_out``,
``_decode_block``,
``_forward_cached``, ``prefill`` and ``generate``. Weight leaves may be
weight-only quantized (``models/quantized_serving.py``): every projection
goes through ``qmatmul`` and the lm_head through ``qhead_matmul``. A
threaded LoRA selection adds each row's adapter delta to the targeted
products (``models/lora_serving.py``).

Where the reference scans the stacked layers with ``lax.scan`` and
returns a fresh cache, the port loops over layers in Python and writes
the cache IN PLACE: ``_forward_cached`` mutates ``cache`` and returns
only the logits. Every cache read goes through
``ops.attention.serving_cache_attention`` — on the card the hand-written
ragged-paged kernel, for decode (T=1) and every prefill chunk alike, on
whichever of its routes the cache's layout and element type name; on
the CPU its plain version, which is the reference's gather branch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from k8s_gpu_device_plugin_torch.models.llama import (
    LlamaConfig,
    apply_rope,
    cast_params_for_compute,
    head_weights,
    mlp_act,
    rms_norm,
    rope_angles,
)
from k8s_gpu_device_plugin_torch.models.lora_serving import maybe_lora
from k8s_gpu_device_plugin_torch.models.moe import router_logits, router_topk
from k8s_gpu_device_plugin_torch.models.quantized_serving import (
    layer_slice,
    qexpert_einsum,
    qhead_matmul,
    qmatmul,
)
from k8s_gpu_device_plugin_torch.models.sampling import (
    Sampler,
    init_presence,
    sample_and_mark_dyn,
    sampler_knobs,
)
from k8s_gpu_device_plugin_torch.ops.attention import serving_cache_attention
from k8s_gpu_device_plugin_torch.ops.quant import (
    pack_int4,
    quantize_int4_sym,
    quantize_int8,
)
from k8s_gpu_device_plugin_torch.ops.ragged_paged_attention import (
    ragged_paged_attention_reference,
)


@dataclass
class KVCache:
    """Per-layer stacked K/V at native kv heads: dense
    (L, B, max_len, Hkv, hd), or a paged pool
    (L, n_pages, page_size, Hkv, hd) that slots reach through
    ``BatchState.pages`` (page 0 is the trap page, models/paging.py).

    With ``cfg.cache_quant == "int8"`` ``k``/``v`` hold int8 codes and
    ``k_scale``/``v_scale`` the per-(position, head) f32 scales, shaped
    like the cache with a last axis of 1: on a pool they ride the same
    page geometry, so one (page, offset) pair addresses a row's codes and
    its scales. With ``"int4"`` the codes are packed two per byte
    (``ops/quant.py``): ``k``/``v`` are uint8 ``(..., hd / 2)``, the
    scale planes the same ``(..., 1)``. The scale planes are None on an
    unquantized cache.

    Slicing the batch axis of a dense cache (``cache.k[:, slot:slot+1]``)
    gives a view, so writes through a slot's view land in the batch."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: "torch.Tensor | None" = None
    v_scale: "torch.Tensor | None" = None

    @staticmethod
    def _alloc(cfg: LlamaConfig, shape: tuple, device) -> "KVCache":
        def zeros(shp, dtype):
            return torch.zeros(shp, dtype=dtype, device=device)

        if cfg.cache_quant in ("int8", "int4"):
            sshape = (*shape[:-1], 1)
            if cfg.cache_quant == "int4":
                dtype, shape = torch.uint8, (*shape[:-1], shape[-1] // 2)
            else:
                dtype = torch.int8
            return KVCache(
                k=zeros(shape, dtype), v=zeros(shape, dtype),
                k_scale=zeros(sshape, torch.float32),
                v_scale=zeros(sshape, torch.float32),
            )
        return KVCache(k=zeros(shape, cfg.dtype), v=zeros(shape, cfg.dtype))

    @staticmethod
    def init(cfg: LlamaConfig, batch: int, max_len: int,
             device: "str | torch.device") -> "KVCache":
        return KVCache._alloc(
            cfg, (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim),
            device,
        )

    @staticmethod
    def init_paged(cfg: LlamaConfig, n_pages: int, page_size: int,
                   device: "str | torch.device") -> "KVCache":
        """The paged pool, ``n_pages`` counting the trap page 0."""
        return KVCache._alloc(
            cfg, (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads,
                  cfg.head_dim), device,
        )

    def slot(self, slot: int) -> "KVCache":
        """The (L, 1, max_len, Hkv, hd) view of one slot's rows of a
        DENSE cache (a pool has no slot axis: its slots are table rows)."""
        def view(x):
            return None if x is None else x[:, slot:slot + 1]

        return KVCache(k=view(self.k), v=view(self.v),
                       k_scale=view(self.k_scale), v_scale=view(self.v_scale))

    def layer(self, i: int) -> tuple:
        """(k, v, k_scale, v_scale) of layer ``i`` (views)."""
        return (self.k[i], self.v[i],
                None if self.k_scale is None else self.k_scale[i],
                None if self.v_scale is None else self.v_scale[i])


def _quantize_kv(x: torch.Tensor, cache_quant: str = "int8",
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, H, hd) -> (int8 codes, unpacked: in [-127, 127] for
    ``"int8"``, [-7, 7] for ``"int4"``; f32 per-(token, head) scales
    (B, T, H, 1)): the one symmetric per-row recipe of ``ops/quant.py``
    at the cache's code width."""
    if cache_quant == "int4":
        return quantize_int4_sym(x, axis=-1)
    return quantize_int8(x, axis=-1)


def _cache_write(cache: torch.Tensor, scale: "torch.Tensor | None",
                 x: torch.Tensor, length: "int | torch.Tensor",
                 pages: "torch.Tensor | None" = None) -> None:
    """Write T new tokens' K or V, (B, T, Hkv, hd), into one layer's
    cache at ``length``: a scalar (every row at one position) or a (B,)
    tensor (every slot at its own position). In place. ``scale`` is the
    matching scale plane of an int8 or int4 cache (else None): the rows
    are quantized at the cache's code width first (a uint8 cache holds
    int4 codes, packed after quantizing) and codes and scales land at the
    same place, so a dense cache and a pool hold byte-identical codes and
    scales.

    With ``pages`` (B, n_slot_pages) int32 the cache is a pool
    (n_pages, page_size, Hkv, hd): position p of row b lands in page
    ``pages[b, p // page_size]`` at offset ``p % page_size``. Positions
    are clamped into the table's virtual extent (an inactive slot parked
    at the virtual last row), and a position past a slot's reservation
    resolves to table entry 0: it lands in the trap page, never in
    another slot's page. Several rows of one call may land on one trap
    row; which of them stays there is not defined and never read
    unmasked."""
    t = x.shape[1]
    if scale is None:
        val, sval = x.to(cache.dtype), None
    elif cache.dtype == torch.uint8:
        val, sval = _quantize_kv(x, "int4")
        val = pack_int4(val)
    else:
        val, sval = _quantize_kv(x, "int8")
    if pages is not None:
        ps = cache.shape[1]
        steps = torch.arange(t, device=cache.device)
        if isinstance(length, torch.Tensor):
            pos = length.long()[:, None] + steps[None, :]
        else:
            pos = (int(length) + steps)[None, :].expand(x.shape[0], t)
        pos = torch.clamp(pos, 0, pages.shape[1] * ps - 1)
        pidx = torch.gather(pages, 1, pos // ps).long()
        off = pos % ps
        cache[pidx, off] = val
        if sval is not None:
            scale[pidx, off] = sval
        return
    targets = ((cache, val),) if sval is None else ((cache, val), (scale, sval))
    if not isinstance(length, torch.Tensor):
        for dst, src in targets:
            dst[:, length:length + t] = src
        return
    rows = torch.arange(x.shape[0], device=cache.device)[:, None]
    pos = length.long()[:, None] + torch.arange(t, device=cache.device)[None, :]
    for dst, src in targets:
        dst[rows, pos] = src


def _cached_attention(q, k_cache, v_cache, k_scale, v_scale, base,
                      cfg: LlamaConfig, pages=None, verify: bool = False,
                      plain: bool = False):
    """q (B, T, Hq, hd) attends its slot's cache rows up to its own
    position: rows are the T new tokens at ``base .. base+T-1``, ``base``
    a (B,) int32 tensor. ``pages`` (B, n_slot_pages) marks the caches as
    a paged pool, the scale planes mark them as int8 or int4 codes;
    ``verify`` marks a speculative verify window. ``plain=True`` runs the plain
    version whatever the device: the comparison path a card run holds
    the kernel path against; serving never sets it."""
    if plain:
        return ragged_paged_attention_reference(
            q, k_cache, v_cache, base, pages, scale=q.shape[-1] ** -0.5,
            window=cfg.sliding_window, k_scale=k_scale, v_scale=v_scale,
        )
    return serving_cache_attention(
        q, k_cache, v_cache, base, pages, verify,
        window=cfg.sliding_window, k_scale=k_scale, v_scale=v_scale,
    )


def _qm_lora(h, layer, name: str, sel, hf=None):
    """``qmatmul`` plus the per-row stacked-adapter delta when this layer
    carries factors and a selection is threaded
    (``models/lora_serving.py``); with ``sel`` None the base path runs
    exactly what it runs without adapters. The delta (rounded to h's
    dtype) is added to the product in h's dtype, as the reference adds
    it; ``hf`` is h in f32, shared by targets that read the same h."""
    y = qmatmul(h, layer[name])
    d = maybe_lora(h, layer, name, sel, hf)
    return y if d is None else y + d


def _lora_hf(h, layer, sel, targets: tuple):
    """h in f32 for the deltas of ``targets``, which share it, or None
    when none of them runs a delta."""
    if sel is None or not any(f"lora_{t}_a" in layer for t in targets):
        return None
    return h.float()


def _project_qkv(x, layer, rot, cfg: LlamaConfig, sel=None):
    """Decode-side QKV projection + rope: (B, T, d) -> q (B, T, Hq, hd),
    k and v (B, T, Hkv, hd); ``rot`` is :func:`rope_angles` of the
    tokens' positions. ``sel`` (B, S) selects each row's stacked LoRA
    adapter: S is the stack the params carry (every adapter in dense-N
    mode, the batch's compact slots when gathered), the one-hot over
    stack positions either way."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps, cfg.norm_offset)
    hf = _lora_hf(h, layer, sel, ("wq", "wk", "wv"))
    q = _qm_lora(h, layer, "wq", sel, hf)
    k = _qm_lora(h, layer, "wk", sel, hf)
    v = _qm_lora(h, layer, "wv", sel, hf)
    if cfg.attn_bias:
        # base-model leaves (adapters never touch them), added after any
        # LoRA delta
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    q = q.reshape(b, t, cfg.n_heads, hd)
    k = k.reshape(b, t, cfg.n_kv_heads, hd)
    v = v.reshape(b, t, cfg.n_kv_heads, hd)
    return apply_rope(q, *rot), apply_rope(k, *rot), v


#: rows of one MoE MLP pass: a longer T runs in chunks of this many
_MOE_PREFILL_CHUNK = 128


def _decode_moe_mlp(h, layer, cfg: LlamaConfig):
    """The serving MoE MLP: every expert computed, mixed by the
    renormalised top-k gates (``models/moe.py::router_topk``, as in
    training). No capacity competition, so no token is dropped: it equals
    training's forward wherever capacity dropped nothing. All E experts
    cost E/k times the sparse FLOPs, and buy static shapes with no
    gather and no host sync (the captured decode graph). T over
    ``_MOE_PREFILL_CHUNK`` runs in chunks of that many rows, so the
    (B, T, E, F) intermediates stay one chunk deep; routing is per
    token, so chunking is exact."""
    t = h.shape[1]
    c = _MOE_PREFILL_CHUNK
    if t > c:
        return torch.cat([_decode_moe_mlp(h[:, i:i + c], layer, cfg)
                          for i in range(0, t, c)], dim=1)
    gates, idx, _ = router_topk(router_logits(h, layer["router"]),
                                cfg.n_experts_per_token)      # (B, T, k)
    # one gate into each chosen expert's column (the top-k are distinct)
    mix = torch.zeros((*idx.shape[:-1], cfg.n_experts), dtype=gates.dtype,
                      device=h.device).scatter_(-1, idx, gates)
    gate = F.silu(qexpert_einsum("btd,edf->btef", h, layer["moe_w1"])
                  .float()).to(h.dtype)
    up = qexpert_einsum("btd,edf->btef", h, layer["moe_w3"])
    y = qexpert_einsum("btef,efd->bted", gate * up, layer["moe_w2"])
    return torch.einsum("bte,bted->btd", mix.to(h.dtype), y)


def _mlp_out(x, layer, cfg: LlamaConfig, sel=None):
    """The MLP residual branch, gated or (MoE) the expert mix
    (``sel``: :func:`_project_qkv`'s; adapters on a MoE config target
    attention only, ``models/lora.py``)."""
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps, cfg.norm_offset)
    if cfg.is_moe:
        return _decode_moe_mlp(h, layer, cfg)
    hf = _lora_hf(h, layer, sel, ("w1", "w3"))
    gate = mlp_act(_qm_lora(h, layer, "w1", sel, hf).float(),
                   cfg).to(x.dtype)
    up = _qm_lora(h, layer, "w3", sel, hf)
    return _qm_lora(gate * up, layer, "w2", sel)


def _decode_block(x, layer, kv, length, base, rot, cfg: LlamaConfig,
                  pages=None, verify: bool = False, plain: bool = False,
                  sel=None):
    """One transformer block over T new tokens: writes their K/V at
    ``length + arange(T)`` (in place), attends, returns x_out. ``kv`` is
    the layer's (k, v, k_scale, v_scale) cache views; ``base`` is
    ``length`` as a (B,) int32 tensor and ``rot`` the rope angles, both
    built once per forward. ``pages`` (B, n_slot_pages) switches the
    cache to the paged pool: writes scatter through the table and reads
    resolve through it. Weight leaves may be quantized (``qmatmul``);
    ``sel`` adds the rows' adapter deltas to every targeted product."""
    b, t, _ = x.shape
    k_cache, v_cache, k_scale, v_scale = kv
    q, k, v = _project_qkv(x, layer, rot, cfg, sel)
    _cache_write(k_cache, k_scale, k, length, pages)
    _cache_write(v_cache, v_scale, v, length, pages)
    attn = _cached_attention(q, k_cache, v_cache, k_scale, v_scale, base,
                             cfg, pages=pages, verify=verify, plain=plain)
    x = x + _qm_lora(attn.reshape(b, t, cfg.n_heads * cfg.head_dim),
                     layer, "wo", sel)
    return x + _mlp_out(x, layer, cfg, sel)


def _forward_cached(
    params: dict,
    tokens: torch.Tensor,              # (B, T) int
    cache: KVCache,
    length: "int | torch.Tensor",      # scalar or (B,) first-token position
    cfg: LlamaConfig,
    *,
    last_only: bool = False,
    select_pos: "int | None" = None,
    pages: "torch.Tensor | None" = None,
    verify: bool = False,
    plain_attention: bool = False,
    lora_sel: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Run T tokens, starting at absolute position ``length``, through
    every layer, writing their K/V into ``cache`` in place. Returns f32
    logits (B, T, V); ``last_only`` projects only the final position and
    ``select_pos`` only that one (a padded prefill chunk whose last real
    token is not its last row). ``pages`` (B, n_slot_pages) int32 marks
    ``cache`` as a paged pool and routes every layer's cache write and
    read through the table (models/batching.py owns the tables);
    ``verify`` marks a speculative verify window. ``plain_attention``
    selects the plain attention version on any device (see
    ``_cached_attention``). ``lora_sel`` (B, S) selects per-row stacked
    LoRA adapters when ``params["layers"]`` carries them
    (``models/lora_serving.py``); None serves the base model with no
    added work."""
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
    sel = None
    if lora_sel is not None:
        # once a forward: the folds run in the stacks' dtype (exact on a
        # one-hot row)
        sel = lora_sel.to(device=device, dtype=cfg.dtype)
    for i in range(cfg.n_layers):
        layer = {name: layer_slice(leaf, i) for name, leaf in layers.items()}
        x = _decode_block(x, layer, cache.layer(i), length, base, rot, cfg,
                          pages=pages, verify=verify, plain=plain_attention,
                          sel=sel)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_offset)
    if last_only:
        x = x[:, -1:]
    elif select_pos is not None:
        x = x[:, select_pos:select_pos + 1]
    return qhead_matmul(x, head_weights(params, cfg), cfg.dtype)


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
    if cfg.quant != "none":
        # the cached decode runs float products: an int8-trained config
        # would decode with other numerics than its training forward
        raise NotImplementedError("decode path is bf16-only (quant='none')")
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
