"""KV-cache forward and generation for serving.

Port of ``k8s_gpu_device_plugin_tpu/models/generate.py``: ``KVCache``
(dense or a paged pool; bf16/f32, or int8 or packed int4 codes with f32
scale planes; ``ShardedKVCache`` its head shards under tensor
parallelism), ``_quantize_kv``, ``_cache_write``, ``_cached_attention``,
``_qm_lora``, ``_project_qkv``, ``_decode_moe_mlp``, ``_mlp_out``,
``_decode_block``, ``_forward_cached``, ``prefill`` and ``generate``.
Weight leaves may be weight-only quantized
(``models/quantized_serving.py``): every projection goes through
``qmatmul`` and the lm_head through ``qhead_matmul``. A
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

The forward is a loop over the shards of a tensor-parallel serving mesh
(``parallel/tp_serving.py``; one shard at tp = 1) where the reference is
one sharded program: each shard projects its q/k/v heads from its
column leaves, writes its own heads' cache rows and launches the kernel
on its own contiguous planes (the reference's ``shard_map``); the heads
are gathered before ``wo``, the MLP's columns before ``w2`` and the
logits before sampling (the reference's ``constrain`` points).
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
from k8s_gpu_device_plugin_torch.parallel.tp_serving import (
    COL,
    ROW,
    ServingMesh,
    replicate,
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
             device: "str | torch.device", tp: int = 1) -> "KVCache":
        """The dense cache; ``tp`` > 1 allocates one shard's
        ``n_kv_heads / tp`` heads."""
        return KVCache._alloc(
            cfg, (cfg.n_layers, batch, max_len, cfg.n_kv_heads // tp,
                  cfg.head_dim), device,
        )

    @staticmethod
    def init_paged(cfg: LlamaConfig, n_pages: int, page_size: int,
                   device: "str | torch.device", tp: int = 1) -> "KVCache":
        """The paged pool, ``n_pages`` counting the trap page 0; ``tp`` >
        1 allocates one shard's ``n_kv_heads / tp`` heads."""
        return KVCache._alloc(
            cfg, (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads // tp,
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


@dataclass
class ShardedKVCache:
    """A cache split on the KV-head axis over a tensor-parallel serving
    mesh (``parallel/tp_serving.py``): shard ``i`` holds heads
    ``[i * Hkv / tp, (i + 1) * Hkv / tp)`` of every plane, scale planes
    included, as one contiguous :class:`KVCache` on ``mesh.devices[i]``.
    It has no ``k``/``v`` of its own: code that touches the planes loops
    over :func:`kv_shards`, so nothing writes one shard by mistake."""

    shards: list
    mesh: object  # parallel.tp_serving.ServingMesh

    @staticmethod
    def init(cfg: LlamaConfig, batch: int, max_len: int,
             mesh) -> "ShardedKVCache":
        return ShardedKVCache(
            [KVCache.init(cfg, batch, max_len, d, mesh.tp)
             for d in mesh.devices], mesh)

    @staticmethod
    def init_paged(cfg: LlamaConfig, n_pages: int, page_size: int,
                   mesh) -> "ShardedKVCache":
        return ShardedKVCache(
            [KVCache.init_paged(cfg, n_pages, page_size, d, mesh.tp)
             for d in mesh.devices], mesh)

    def slot(self, slot: int) -> "ShardedKVCache":
        return ShardedKVCache([c.slot(slot) for c in self.shards], self.mesh)


def kv_shards(cache) -> list:
    """The caches a write or a copy must touch: a :class:`KVCache`'s
    one, a :class:`ShardedKVCache`'s per-shard ones."""
    return cache.shards if isinstance(cache, ShardedKVCache) else [cache]


def scratch_cache(cfg: LlamaConfig, batch: int, max_len: int, like):
    """A fresh dense cache of ``batch`` rows x ``max_len`` placed like
    ``like``: a cache, a serving mesh, or a device (tp = 1). The scratch
    a bucketed prefill or a precomputed prefix runs through."""
    if isinstance(like, ShardedKVCache):
        like = like.mesh
    if hasattr(like, "devices"):  # a parallel.tp_serving.ServingMesh
        return ShardedKVCache.init(cfg, batch, max_len, like)
    if isinstance(like, KVCache):
        like = like.k.device
    return KVCache.init(cfg, batch, max_len, like)


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


def _tp_cols(y: torch.Tensor, shard: int, width: int) -> torch.Tensor:
    """Shard ``shard``'s ``width`` output columns: ``y`` itself when it
    came from a column shard (or is whole at tp = 1), else the slice of a
    whole product (a replicated quantized leaf, a LoRA delta, an
    unsharded bias)."""
    if y.shape[-1] == width:
        return y
    return y.narrow(-1, shard * width, width)


def _qm_lora(h, layer, name: str, sel, hf=None, shard: int = 0,
             width: "int | None" = None):
    """``qmatmul`` plus the per-row stacked-adapter delta when this layer
    carries factors and a selection is threaded
    (``models/lora_serving.py``); with ``sel`` None the base path runs
    exactly what it runs without adapters. The delta (rounded to h's
    dtype) is added to the product in h's dtype, as the reference adds
    it; ``hf`` is h in f32, shared by targets that read the same h.
    ``width`` keeps shard ``shard``'s output columns of a tensor-parallel
    forward: the product of its column leaf, or the whole product of a
    replicated leaf cut to them, plus the cut of the whole delta."""
    y = qmatmul(h, layer[name])
    d = maybe_lora(h, layer, name, sel, hf)
    if width is not None:
        y = _tp_cols(y, shard, width)
        d = None if d is None else _tp_cols(d, shard, width)
    return y if d is None else y + d


def _lora_hf(h, layer, sel, targets: tuple):
    """h in f32 for the deltas of ``targets``, which share it, or None
    when none of them runs a delta."""
    if sel is None or not any(f"lora_{t}_a" in layer for t in targets):
        return None
    return h.float()


_QKV = ("wq", "wk", "wv")


def _shard_qkv(h, hf, layer, rot, cfg: LlamaConfig, sel, shard: int = 0,
               tp: int = 1):
    """Shard ``shard`` of ``tp``'s q (B, T, Hq/tp, hd), k and v
    (B, T, Hkv/tp, hd) heads from the normed ``h``, roped; ``hf`` is
    :func:`_lora_hf`'s."""
    b, t, _ = h.shape
    hd = cfg.head_dim
    hq, hkv = cfg.n_heads // tp, cfg.n_kv_heads // tp
    q = _qm_lora(h, layer, "wq", sel, hf, shard, hq * hd)
    k = _qm_lora(h, layer, "wk", sel, hf, shard, hkv * hd)
    v = _qm_lora(h, layer, "wv", sel, hf, shard, hkv * hd)
    if cfg.attn_bias:
        # base-model leaves (adapters never touch them), added after any
        # LoRA delta
        q = q + _tp_cols(layer["bq"], shard, hq * hd)
        k = k + _tp_cols(layer["bk"], shard, hkv * hd)
        v = v + _tp_cols(layer["bv"], shard, hkv * hd)
    q = apply_rope(q.reshape(b, t, hq, hd), *rot)
    return q, apply_rope(k.reshape(b, t, hkv, hd), *rot), \
        v.reshape(b, t, hkv, hd)


def _project_qkv(x, layer, rot, cfg: LlamaConfig, sel=None):
    """Decode-side QKV projection + rope: (B, T, d) -> q (B, T, Hq, hd),
    k and v (B, T, Hkv, hd); ``rot`` is :func:`rope_angles` of the
    tokens' positions. ``sel`` (B, S) selects each row's stacked LoRA
    adapter: S is the stack the params carry (every adapter in dense-N
    mode, the batch's compact slots when gathered), the one-hot over
    stack positions either way."""
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps, cfg.norm_offset)
    return _shard_qkv(h, _lora_hf(h, layer, sel, _QKV), layer, rot, cfg, sel)


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


def _mlp_hidden(h, hf, layer, cfg: LlamaConfig, sel, shard: int = 0,
                width: "int | None" = None):
    """The gated MLP's hidden activation ``act(h w1) * (h w3)`` from the
    normed ``h``: all of it, or shard ``shard``'s ``width`` columns."""
    gate = mlp_act(_qm_lora(h, layer, "w1", sel, hf, shard, width).float(),
                   cfg).to(h.dtype)
    return gate * _qm_lora(h, layer, "w3", sel, hf, shard, width)


def _mlp_out(x, layer, cfg: LlamaConfig, sel=None):
    """The MLP residual branch, gated or (MoE) the expert mix
    (``sel``: :func:`_project_qkv`'s; adapters on a MoE config target
    attention only, ``models/lora.py``)."""
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps, cfg.norm_offset)
    if cfg.is_moe:
        return _decode_moe_mlp(h, layer, cfg)
    hidden = _mlp_hidden(h, _lora_hf(h, layer, sel, ("w1", "w3")), layer,
                         cfg, sel)
    return _qm_lora(hidden, layer, "w2", sel)


def _row_sum(parts: list, device: torch.device) -> torch.Tensor:
    """The ``tp_allow_psum`` reduction: the shards' partial products,
    each rounded to its dtype by its own matmul, summed on ``device`` in
    shard order in that dtype (XLA's psum of a row-sharded bf16
    ``dot_general``: per-shard bf16 partials, an all-reduce add in
    bf16)."""
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


def _contract(acts: list, lays: list, rep: dict, name: str, place: dict,
              sel: dict) -> dict:
    """``wo`` or ``w2`` over the shards' head or column activations
    ``acts``, per distinct device (``rep``'s keys): gathered (a
    ``torch.cat``, data movement only; a tp = 1 forward's one part is
    taken as it is) and contracted whole, or under ``tp_allow_psum`` the
    shards' partial products of their row leaves summed, the LoRA delta
    of the gathered activation added after."""
    parts = None
    if place.get(name) == ROW:
        parts = [qmatmul(a, lays[s][name]) for s, a in enumerate(acts)]
    out = {}
    for d in rep:
        g = acts[0] if len(acts) == 1 else torch.cat(
            [a.to(d) for a in acts], dim=-1)
        if parts is None:
            out[d] = _qm_lora(g, rep[d], name, sel[d])
            continue
        y = _row_sum(parts, d)
        delta = maybe_lora(g, rep[d], name, sel[d])
        out[d] = y if delta is None else y + delta
    return out


def _decode_block(xs: dict, lays: list, kvs: list, length: dict,
                  base: dict, rot: dict, cfg: LlamaConfig, mesh,
                  place: dict, pages: dict, verify: bool, plain: bool,
                  sel: dict) -> dict:
    """One transformer block over T new tokens, over the shards of
    ``mesh`` (one at tp = 1): writes their K/V at ``length +
    arange(T)`` (in place), attends, returns x_out. ``xs`` maps each
    distinct device of the mesh to its replica of the residual stream;
    ``lays`` and ``kvs`` are the shards' layer leaves (quantized ones go
    through ``qmatmul``) and (k, v, k_scale, v_scale) cache views; the
    other dicts hold per-device replicas of the forward's inputs:
    ``length`` as given, ``base`` it as a (B,) int32 tensor, ``rot`` the
    rope angles, ``pages`` (B, n_slot_pages) the page table that
    switches the cache to the paged pool (writes scatter through it and
    reads resolve through it) or None, ``sel`` the rows' adapter
    selection or None. Each shard projects its q/k/v heads from its
    column leaves, writes its own heads' cache rows and attends them
    (the kernel on its contiguous planes); the heads are gathered before
    ``wo``, the MLP's columns before ``w2``, unless ``place`` row-shards
    them (``tp_allow_psum``)."""
    tp = mesh.tp
    rep = {d: lays[mesh.first_shard_on(d)] for d in xs}
    b, t, _ = next(iter(xs.values())).shape
    hs = {d: rms_norm(x, rep[d]["attn_norm"], cfg.norm_eps,
                      cfg.norm_offset) for d, x in xs.items()}
    hfs = {d: _lora_hf(hs[d], rep[d], sel[d], _QKV) for d in xs}
    attn = []
    for s, dev in enumerate(mesh.devices):
        q, k, v = _shard_qkv(hs[dev], hfs[dev], lays[s], rot[dev], cfg,
                             sel[dev], s, tp)
        k_cache, v_cache, k_scale, v_scale = kvs[s]
        _cache_write(k_cache, k_scale, k, length[dev], pages[dev])
        _cache_write(v_cache, v_scale, v, length[dev], pages[dev])
        attn.append(_cached_attention(
            q, k_cache, v_cache, k_scale, v_scale, base[dev], cfg,
            pages=pages[dev], verify=verify, plain=plain).reshape(b, t, -1))
    y = _contract(attn, lays, rep, "wo", place, sel)
    xs = {d: x + y[d] for d, x in xs.items()}
    if cfg.is_moe or place.get("w1") != COL:
        # tp = 1, the dense-mix MoE decode and a replicated MLP run whole
        return {d: x + _mlp_out(x, rep[d], cfg, sel[d])
                for d, x in xs.items()}
    ff = cfg.d_ff // tp
    hs = {d: rms_norm(x, rep[d]["mlp_norm"], cfg.norm_eps, cfg.norm_offset)
          for d, x in xs.items()}
    hfs = {d: _lora_hf(hs[d], rep[d], sel[d], ("w1", "w3")) for d in xs}
    hidden = [_mlp_hidden(hs[dev], hfs[dev], lays[s], cfg, sel[dev], s, ff)
              for s, dev in enumerate(mesh.devices)]
    y = _contract(hidden, lays, rep, "w2", place, sel)
    return {d: x + y[d] for d, x in xs.items()}


def _forward_shards(params, cache, cfg: LlamaConfig, device) -> tuple:
    """(mesh, one weight tree a shard, placement, one cache a shard) of a
    forward. A ``ShardedParams`` and a :class:`ShardedKVCache` carry
    their mesh (``parallel/tp_serving.py``), as a jax array carries its
    sharding; a plain tree and cache serve tp = 1 as the one-shard mesh
    on ``device``. Anything else raises: no tp > 1 forward runs
    unsharded."""
    mesh = getattr(params, "mesh", None)
    if mesh is None and cfg.tp == 1 and not isinstance(cache,
                                                       ShardedKVCache):
        return (ServingMesh((device,)), [cast_params_for_compute(params, cfg)],
                {}, [cache])
    if mesh is None or not isinstance(cache, ShardedKVCache):
        raise ValueError(
            f"a tp={cfg.tp} forward needs the serving mesh: params from "
            "parallel.tp_serving.shard_serving_params and a "
            f"ShardedKVCache, got {type(params).__name__} and "
            f"{type(cache).__name__}")
    if mesh.tp != cfg.tp or cache.mesh != mesh:
        raise ValueError(
            f"cfg.tp={cfg.tp} but the params are sharded over a "
            f"{mesh.tp}-shard mesh and the cache over "
            f"{cache.mesh.tp} shards of {cache.mesh.devices}")
    return mesh, params.shards, params.placement, cache.shards


def _forward_cached(
    params: dict,
    tokens: torch.Tensor,              # (B, T) int
    cache: "KVCache | ShardedKVCache",
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
    added work.

    A ``cfg.tp`` > 1 config takes a ``ShardedParams`` and a
    :class:`ShardedKVCache` over one mesh (:func:`_forward_shards`): the
    replicated work (embedding, norms, ``wo``, ``w2``, the lm_head's
    gather) runs once on each distinct device of the mesh, the head and
    column work once a shard, and the logits land on the mesh's primary
    device. At tp = 1 the mesh is ``tokens``' device alone."""
    mesh, trees, placement, caches = _forward_shards(params, cache, cfg,
                                                     tokens.device)
    prim = mesh.primary
    b, t = tokens.shape
    tok = replicate(tokens.to(prim).long(), mesh)
    xs = {}
    for d in mesh.distinct:
        x = trees[mesh.first_shard_on(d)]["embed"][tok[d]].to(cfg.dtype)
        if cfg.scale_embed:
            x = x * torch.full((), math.sqrt(cfg.d_model), dtype=cfg.dtype,
                               device=d)
        xs[d] = x
    steps = torch.arange(t, dtype=torch.int32, device=prim)
    if isinstance(length, torch.Tensor):  # per-slot positions (B, T)
        base = length.to(device=prim, dtype=torch.int32).contiguous()
        positions = base[:, None] + steps[None, :]
        lengths = replicate(length.to(prim), mesh)
    else:
        base = torch.full((b,), int(length), dtype=torch.int32, device=prim)
        positions = int(length) + steps
        lengths = {d: length for d in mesh.distinct}
    cos, sin = (replicate(x, mesh) for x in rope_angles(
        positions, cfg.head_dim, cfg.rope_theta))
    rot = {d: (cos[d], sin[d]) for d in mesh.distinct}
    bases = replicate(base, mesh)
    pages_r = (replicate(pages.to(prim), mesh) if pages is not None
               else {d: None for d in mesh.distinct})
    sel = {d: None for d in mesh.distinct}
    if lora_sel is not None:
        # once a forward: the folds run in the stacks' dtype (exact on a
        # one-hot row)
        sel = replicate(lora_sel.to(device=prim, dtype=cfg.dtype), mesh)
    place = placement.get("layers", {})
    for i in range(cfg.n_layers):
        lays = [{name: layer_slice(leaf, i)
                 for name, leaf in tree["layers"].items()} for tree in trees]
        xs = _decode_block(
            xs, lays, [c.layer(i) for c in caches], lengths, bases, rot,
            cfg, mesh, place, pages_r, verify, plain_attention, sel)
    for d in xs:
        x = rms_norm(xs[d], trees[mesh.first_shard_on(d)]["final_norm"],
                     cfg.norm_eps, cfg.norm_offset)
        if last_only:
            x = x[:, -1:]
        elif select_pos is not None:
            x = x[:, select_pos:select_pos + 1]
        xs[d] = x
    if placement.get("lm_head") == COL:
        # vocab columns a shard, gathered for sampling: data movement
        parts = [qhead_matmul(xs[dev], trees[s]["lm_head"], cfg.dtype)
                 for s, dev in enumerate(mesh.devices)]
        return torch.cat([p.to(prim) for p in parts], dim=-1)
    return qhead_matmul(xs[prim], head_weights(trees[0], cfg), cfg.dtype)


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
