"""Ragged-paged attention: the serving cache-attention kernel's wrapper
and its plain PyTorch version.

Port of ``k8s_gpu_device_plugin_tpu/ops/ragged_paged_attention.py``
(entry ``ragged_paged_attention``, kernel ``_rpa_kernel``). A batch of
query windows, each at a per-slot base position, attends the slot's
live span of the KV cache: row r of slot b sits at
``q_pos = max(base[b] + r, 0)`` and keeps cache rows ``pos <= q_pos``
(and ``q_pos - pos < window`` when ``window > 0``). T = 1 is decode,
T > 1 a prefill chunk (or a verify window); any T works, because the
kernel's row tiles are independent blocks.

Six routes, one kernel source (:data:`ROUTES`): the cache is dense
``(B, S, Hkv, hd)`` or a pool of pages ``(n_pages, ps, Hkv, hd)`` read
through a ``(B, n_slot_pages)`` int32 table, and it holds q's dtype, int8
codes, or int4 codes packed two per byte as uint8 ``(..., hd / 2)``
(``ops/quant.py`` states the packing), the codes with two f32 scale
planes (``k_scale``/``v_scale``, the cache's shape with a last axis of
1) that the kernel multiplies in before either product.

- CUDA tensors launch the hand-written kernel
  (``csrc/ragged_paged_attention.cu``), built at first use and counted
  in ``kernel_support.launch_counts()`` under :data:`NAME`, under its
  route's key (:func:`route_key`) and under its engine's key
  (:func:`engine`); anything the kernel does not take raises. Every bf16
  launch runs on the tensor cores, f32 queries on the CUDA cores; the
  wrapper makes that choice and the C interface launches the engine it is
  given. A narrow bf16 window (decode, verify: at most
  :data:`NARROW_TILE` query vectors) splits each live span into splits of
  :data:`SPLIT_TILES` kv tiles, one block each (:func:`split_plan`),
  combined in the kernel.
- CPU tensors take :func:`ragged_paged_attention_reference`, the
  gather-einsum of the reference's ``generate._cached_attention`` with
  the kernel's ``q_pos`` clamp. Nothing gives way from the kernel to it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from k8s_gpu_device_plugin_torch.ops import kernel_support
from k8s_gpu_device_plugin_torch.ops.quant import unpack_int4

NAME = "ragged_paged_attention"
SOURCE = kernel_support.CSRC_DIR / "ragged_paged_attention.cu"

#: widest GQA group one block folds (64 q vectors per row tile)
MAX_GROUP = 64

#: smallest page the paged route takes (the reference's sublane rule)
MIN_PAGE_SIZE = 8

#: widest verify window (the reference's ``MAX_VERIFY_T``)
MAX_VERIFY_T = 16

#: the kernel's routes: cache element type x cache layout
ROUTES = ("dense", "paged", "int8_dense", "int8_paged", "int4_dense",
          "int4_paged")

#: cache element type of each code width, and the C interface's code
_CODES = {"none": 0, "int8": 8, "int4": 4}
_CODE_DTYPES = {torch.int8: "int8", torch.uint8: "int4"}

_NEG_BIG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def route_name(paged: bool, cache_quant: str = "none") -> str:
    """The route of a layout and a ``cache_quant`` (``'none'``,
    ``'int8'`` or ``'int4'``)."""
    if cache_quant not in _CODES:
        raise ValueError(f"cache_quant must be one of {list(_CODES)}, got "
                         f"{cache_quant!r}")
    prefix = "" if cache_quant == "none" else cache_quant + "_"
    return prefix + ("paged" if paged else "dense")


def route_key(route: str) -> str:
    """The ``launch_counts()`` key of one route's launches."""
    return f"{NAME}{{{route}}}"


#: query vectors of a narrow window (decode, verify): the CUDA-core
#: kernel's narrow row tile, and the most a split launch takes
NARROW_TILE = 8

#: kv tiles of one split of a narrow window on the tensor cores: the same
#: for every launch (PERF.md says why this value)
SPLIT_TILES = 4


def engine(dtype: torch.dtype, t: int, group: int) -> str:
    """The engine a launch of ``t`` query rows at GQA ``group`` runs on:
    ``'tensor_cores'`` for bf16 queries at every window (a narrow one split
    by :func:`window_split`), ``'cuda_cores'`` for f32 queries at every
    window (the f32 pins need f32 products)."""
    return "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores"


def window_split(t: int, group: int) -> "int | None":
    """The kv tiles a split of this window holds on the tensor cores:
    :data:`SPLIT_TILES` for a narrow window (``group * t <=``
    :data:`NARROW_TILE`), None for a chunk (one block walks its row tile's
    whole span)."""
    return SPLIT_TILES if group * t <= NARROW_TILE else None


def n_splits(s_len: int, split_tiles: int) -> int:
    """The split launch's grid depth: ``ceil(s_len / (64 split_tiles))``
    of the cache's (or the table's virtual) extent, never of the data."""
    return -(-s_len // (kernel_support.TC_KV_TILE * split_tiles))


def split_plan(base, t: int, window: int, s_len: int,
               split_tiles: int) -> list[list[tuple[int, int, int]]]:
    """Each slot's live splits as a narrow window's split launch walks
    them: ``(split, first tile, last tile)`` in ascending order. The row
    tile (all T query rows) reads the live span ``first_block(base + 1)
    .. last_block(base + T)`` of 64-row kv tiles, clipped to ``s_len``;
    split z covers the absolute tiles ``[z K, (z + 1) K)`` of it (K =
    ``split_tiles``), so a slot's splits depend on its own base alone.
    The kernel mirrors this (``rpa_tc_kernel``); a split outside the list
    exits before it reads anything."""
    tile, k = kernel_support.TC_KV_TILE, split_tiles
    j_max = -(-s_len // tile) - 1
    plan = []
    for b0 in (int(x) for x in base):
        hi = min(max(-(-(b0 + t) // tile) - 1, 0), j_max)
        lo = min(max(b0 + 1 - window, 0) // tile if window > 0 else 0, hi)
        plan.append([(z, max(lo, z * k), min(hi, z * k + k - 1))
                     for z in range(lo // k, hi // k + 1)])
    return plan


def page_size_refusal(page_size: int) -> "str | None":
    """Why the paged route does not take this page size, or None. The
    kernel resolves a cache row with a shift and a mask, so a page holds
    a power of two of rows; pages may be smaller or larger than its
    64-row kv tile."""
    ps = int(page_size)
    if ps < MIN_PAGE_SIZE or ps & (ps - 1):
        return (f"kv_page_size={page_size} is not a power of two >= "
                f"{MIN_PAGE_SIZE}")
    return None


def attended_rows(base: torch.Tensor, t: int, window: int = 0) -> torch.Tensor:
    """(B, T) int64: how many cache rows query ``r`` of each slot
    attends. The kernel reads the live span
    ``first_block(base + 1) .. last_block(base + T)`` of its 64-row kv
    tiles (the C++ helpers of those names port the reference's
    ``_first_block``/``_last_block``); this is the data-dependent work
    a bound on it counts."""
    q_pos = torch.clamp(
        base[:, None].long() + torch.arange(t, device=base.device), min=0
    )
    rows = q_pos + 1
    if window > 0:
        rows = torch.clamp(rows, max=window)
    return rows


#: ``rpa_forward``'s C signature: pointers (q, k, v, k_scale, v_scale,
#: base, pages, out, part), (dtype, codes, b, t, hq, hkv, s_len, hd,
#: page_shift), scale, window, engine, split_tiles, stream
ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = kernel_support.load_library(NAME, [SOURCE])
    lib.rpa_forward.argtypes = ARGTYPES
    lib.rpa_forward.restype = ctypes.c_int
    lib.rpa_blocks_per_sm.restype = ctypes.c_int
    return lib


def _check(q, k, v, base, pages, k_scale, v_scale) -> None:
    """Shape checks shared by both devices."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    layout = ("a pool (n_pages, ps, Hkv, hd)" if pages is not None
              else "dense (B, S, Hkv, hd)")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(
            f"q must be (B, T, Hq, hd) and k/v {layout}; got "
            f"{tuple(q.shape)} and {tuple(k.shape)}"
        )
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} != v {tuple(v.shape)}")
    b, t, hq, hd = q.shape
    hkv = k.shape[2]
    codes = _CODE_DTYPES.get(k.dtype, "none")
    # packed int4 codes hold two of the head dim's elements a byte
    if k.shape[3] * (2 if codes == "int4" else 1) != hd or \
            (pages is None and k.shape[0] != b):
        raise ValueError(
            f"cache {tuple(k.shape)} {k.dtype} does not match q "
            f"{tuple(q.shape)}"
        )
    if not kernel_support.gqa_ok(hq, hkv) or hq // hkv > MAX_GROUP:
        raise ValueError(
            f"Hq={hq} must be a multiple of Hkv={hkv} with a group of at "
            f"most {MAX_GROUP}"
        )
    if base.shape != (b,):
        raise ValueError(f"base must be ({b},), got {tuple(base.shape)}")
    if k_scale is not None:
        if codes == "none" or v.dtype != k.dtype:
            raise ValueError(
                f"scale planes come with int8 codes or packed int4 codes "
                f"(uint8); got k {k.dtype}, v {v.dtype}"
            )
        want = (*k.shape[:-1], 1)
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(x.shape) != want or x.dtype != torch.float32:
                raise ValueError(
                    f"{name} must be f32 {want} (the cache's shape with a "
                    f"last axis of 1), got {x.dtype} {tuple(x.shape)}"
                )
    elif codes != "none":
        raise ValueError(f"an {codes} cache needs k_scale and v_scale "
                         f"(got {k.dtype} codes without them)")
    if pages is not None:
        why = page_size_refusal(k.shape[1])
        if why:
            raise ValueError(why)
        if pages.dim() != 2 or pages.shape[0] != b or pages.shape[1] < 1:
            raise ValueError(
                f"pages must be ({b}, n_slot_pages), got {tuple(pages.shape)}"
            )
        if pages.dtype != torch.int32:
            raise ValueError(f"pages must be int32, got {pages.dtype}")
    devs = {x.device for x in (q, k, v, base, pages, k_scale, v_scale)
            if x is not None}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {devs}")


def ragged_paged_attention(
    q: torch.Tensor,          # (B, T, Hq, hd)
    k: torch.Tensor,          # dense (B, S, Hkv, hd) | pool (n_pages, ps, Hkv, hd)
    v: torch.Tensor,
    base: torch.Tensor,       # (B,) int32: position of each slot's first query
    pages: "torch.Tensor | None" = None,  # (B, n_slot_pages) int32 page table
    *,
    scale: float,
    window: int = 0,
    k_scale: "torch.Tensor | None" = None,  # f32, k's shape with hd = 1
    v_scale: "torch.Tensor | None" = None,
    engine_override: "str | None" = None,
) -> torch.Tensor:
    """(B, T, Hq, hd) cache attention over each slot's live span, in q's
    dtype. The caller has already written the window's own K/V rows
    (the serving contract: live rows are ``base + T``). With ``pages``
    the cache is a pool and slot b's row ``pos`` is row ``pos % ps`` of
    page ``pages[b, pos // ps]``; a table id is never checked on the
    device (the batcher's rows come from ``PagePool``). ``k_scale`` and
    ``v_scale`` (both or neither) mark k/v as codes: int8, or int4 packed
    two per byte into uint8 ``(..., hd / 2)``. ``engine_override`` runs
    a CUDA launch on that engine instead of :func:`engine`'s (the
    tensor cores take bf16 q only): a yardstick of one engine against the
    other on the same inputs. On the tensor cores a narrow window splits
    its spans (:func:`window_split`); the combine is part of the launch."""
    _check(q, k, v, base, pages, k_scale, v_scale)
    kw = dict(scale=scale, window=window, k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(q, k, v, base, pages, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, t, hq, hd = q.shape
    quantized = k_scale is not None
    cache_quant = _CODE_DTYPES[k.dtype] if quantized else "none"
    if not kernel_support.lane_aligned(hd):
        raise ValueError(f"head_dim={hd} not in {kernel_support.LANE_ALIGNED_HEAD_DIMS}")
    if q.dtype not in _DTYPES or (not quantized and k.dtype != q.dtype):
        raise ValueError(
            f"q must have a dtype of {list(_DTYPES)} and k/v the same one "
            f"(or int8/uint8 codes with scale planes); got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if base.dtype != torch.int32:
        raise ValueError(f"base must be int32, got {base.dtype}")
    operands = (("q", q), ("k", k), ("v", v), ("base", base), ("pages", pages),
                ("k_scale", k_scale), ("v_scale", v_scale))
    for name, x in operands:
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if pages is None:
        s_len, page_shift = k.shape[1], 0
    else:
        # the table's virtual extent is what the kernel's grid walks
        s_len = pages.shape[1] * k.shape[1]
        page_shift = k.shape[1].bit_length() - 1
    eng = engine_override or engine(q.dtype, t, hq // k.shape[2])
    if eng not in kernel_support.ENGINES or (
            eng == "tensor_cores" and q.dtype != torch.bfloat16):
        raise ValueError(f"engine {eng!r} is not one of "
                         f"{kernel_support.ENGINES} or does not take "
                         f"{q.dtype} q (the tensor cores take bf16 q)")
    hkv = k.shape[2]
    split = window_split(t, hq // hkv) if eng == "tensor_cores" else None
    part = None
    if split is not None:  # each split's (o, m, l) of its query vectors
        part = torch.empty(b * hkv * n_splits(s_len, split) * NARROW_TILE
                           * (hd + 2), dtype=torch.float32, device=q.device)
    lib = load_kernel()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.rpa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        base.data_ptr(), None if pages is None else pages.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        _DTYPES[q.dtype], _CODES[cache_quant], b, t, hq, hkv, s_len, hd,
        page_shift, float(scale), int(window),
        kernel_support.ENGINES.index(eng), split or 0, stream,
    )
    route = route_name(pages is not None, cache_quant)
    if err != 0:
        raise RuntimeError(
            f"ragged_paged_attention kernel launch failed: cudaError {err} "
            f"(route {route}, engine {eng}, q {tuple(q.shape)} {q.dtype}, "
            f"cache {tuple(k.shape)} {k.dtype})"
        )
    kernel_support.count_launch(NAME)
    kernel_support.count_launch(route_key(route))
    kernel_support.count_launch(kernel_support.engine_key(NAME, eng))
    return out


def ragged_paged_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, base: torch.Tensor,
    pages: "torch.Tensor | None" = None,
    *, scale: float, window: int = 0,
    k_scale: "torch.Tensor | None" = None,
    v_scale: "torch.Tensor | None" = None,
    p_bf16: bool = False,
    split_tiles: "int | None" = None,
) -> torch.Tensor:
    """The plain version: the gather einsum of the reference's
    ``_cached_attention`` (scores from q's-dtype operands with f32
    accumulation, a plain f32 softmax over the whole cache, probs cast to
    q's dtype for the V contraction) plus the kernel's ``q_pos`` clamp,
    which changes nothing for a live slot (base >= 0). A pool is first
    gathered through ``pages`` into the dense ``(B, S, Hkv, hd)`` view,
    codes and scales alike, so the two layouts run one computation.
    Packed int4 codes are unpacked to int8 first. Codes stay the
    products' operands (cast to q's dtype, exactly); the
    per-(row, head) scales commute through the contractions, so
    ``k_scale`` multiplies the scores after the K product and
    ``v_scale`` the probabilities before the V product. Runs on any
    device; the wrapper takes it only for CPU tensors.

    ``p_bf16`` computes what the tensor-core engine does instead, for bf16
    q: codes times their scale in f32 rounded once to bf16 (the K/V rows
    its producer writes), scores from those rows, the weights rounded to
    bf16 against the running max of each 64-row kv tile
    (``kernel_support.p_bf16_weights``), o divided by the sum of the
    unrounded weights. The engine is held to it at one bf16 ulp
    (``kernel_support.bf16_o_mismatch``). With ``split_tiles`` (a narrow
    window's split launch, :func:`window_split`) the running max restarts
    at each split of that many absolute kv tiles (:func:`split_plan`) and
    the splits' weights are rescaled to the row's max in f32, as the
    kernel's combine does; None walks the span as one."""
    b, t, hq, hd = q.shape
    if k.dtype == torch.uint8:
        k, v = unpack_int4(k), unpack_int4(v)
    if pages is not None:
        idx = pages.long()

        def gather(pool):
            return pool[idx].reshape(b, -1, *pool.shape[-2:])

        k, v = gather(k), gather(v)
        if k_scale is not None:
            k_scale, v_scale = gather(k_scale), gather(v_scale)
    if p_bf16 and k_scale is not None:
        k = (k.float() * k_scale).to(torch.bfloat16)
        v = (v.float() * v_scale).to(torch.bfloat16)
        k_scale = v_scale = None
    s_len, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, t, hkv, group, hd).float()
    scores = torch.einsum("btkgd,bskd->btkgs", qg, k.to(q.dtype).float())
    scores = scores * scale
    if k_scale is not None:
        # (B, S, Hkv, 1) -> (B, Hkv, S), broadcast over (b, t, k, g, s)
        scores = scores * k_scale[..., 0].transpose(1, 2)[:, None, :, None, :]
    q_pos = torch.clamp(
        base.long()[:, None] + torch.arange(t, device=q.device)[None, :],
        min=0,
    )[:, :, None, None, None]
    k_pos = torch.arange(s_len, device=q.device)[None, None, None, None, :]
    keep = k_pos <= q_pos
    if window > 0:
        keep &= q_pos - k_pos < window
    scores = torch.where(keep, scores, torch.full_like(scores, _NEG_BIG))
    if p_bf16:
        m = scores.amax(dim=-1, keepdim=True)
        l = torch.exp(scores - m).sum(dim=-1, keepdim=True)
        probs = kernel_support.p_bf16_weights(
            scores, m, split_tiles=split_tiles) / l.clamp(min=1e-30)
        out = torch.einsum("btkgs,bskd->btkgd", probs, v.float())
        return out.reshape(b, t, hq, hd).to(q.dtype)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[..., 0].transpose(1, 2)[:, None, :, None, :]
    probs = probs.to(q.dtype).float()
    out = torch.einsum("btkgs,bskd->btkgd", probs, v.to(q.dtype).float())
    return out.reshape(b, t, hq, hd).to(q.dtype)
