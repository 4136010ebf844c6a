"""Host-side page pool for the paged KV cache (models/batching.py).

Port of ``k8s_gpu_device_plugin_tpu/models/paging.py``: ``PagePool``,
``kv_token_bytes``, ``kv_shard_token_bytes`` and the KV transfer wire
format (``pack_kv_wire`` / ``unpack_kv_wire``, below).

The dense serving cache reserves ``n_slots * max_len`` token rows of
device memory up front, so a 40-token request in a 2048-token slot
strands 98% of its reservation. The paged layout carves the KV memory
into fixed-size pages of ``page_size`` token rows and maps each slot's
virtual positions onto physical pages through a per-slot int32 page
table. This module is the host half: a free-list allocator with
per-page reference counts. It never touches device memory. The device
side is the ``(L, n_pages, page_size, Hkv, hd)`` pool in
``generate.KVCache`` and the table rows in ``BatchState.pages``; the
batcher keeps the two in step (every table row it uploads was first
reserved here). Under tensor-parallel serving the pool stays one host
allocator: each shard holds ``n_kv_heads / tp`` heads of every page
(``generate.ShardedKVCache``), and a page id means the same page on
every shard, so one table row serves them all.

Page 0 is reserved as the trap page: unset table entries point at it,
and the decode step redirects inactive slots' writes to it, so a freed
and reallocated page can never be written by its previous owner (the
paged twin of the dense layout's last-row write redirect). Reference
counts let several holders share a page (prefix aliasing, when it is
ported): a page returns to the free list when its last holder drops it.

Single-threaded, like the batcher that owns it: every call happens on
the engine thread.
"""

from __future__ import annotations

import base64
import math

import numpy as np
import torch

from k8s_gpu_device_plugin_torch.ops.quant import pack_int4, unpack_int4


class PagePool:
    """Free-list page allocator with reference counts.

    ``n_pages`` counts physical pages including the reserved trap page
    0, so ``capacity`` (allocatable pages) is ``n_pages - 1``. ``alloc``
    raises on exhaustion: callers check :attr:`free_pages` first (the
    batcher defers an admission instead of failing mid-flight)."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(
                f"page pool needs >= 2 pages (1 allocatable + the "
                f"reserved trap page 0), got {n_pages}"
            )
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # LIFO free list: recently freed pages are reused first
        self._free: list[int] = list(range(n_pages - 1, 0, -1))
        self._refs: dict[int, int] = {}
        #: high-water mark of pages in use at once
        self.peak_in_use = 0
        #: pages freed through :meth:`recycle`, counted apart from the
        #: release at retirement
        self.recycled_total = 0

    # --- capacity views ---

    @property
    def capacity(self) -> int:
        """Allocatable pages (the trap page excluded)."""
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    def pages_for_tokens(self, n_tokens: int) -> int:
        """Pages covering ``n_tokens`` contiguous rows (ceil division)."""
        return -(-int(n_tokens) // self.page_size)

    # --- allocation ---

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` pages off the free list (each at refcount 1)."""
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, free {len(self._free)} "
                f"(capacity {self.capacity})"
            )
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return out

    def incref(self, pages) -> None:
        """Add one reference to each of ``pages``: the new holder shares
        the physical rows."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"incref of unallocated page {p}")
            self._refs[p] += 1

    def decref(self, pages) -> list[int]:
        """Drop one reference from each of ``pages``; pages reaching
        zero return to the free list. Returns the freed page ids."""
        freed = []
        for p in pages:
            r = self._refs.get(p)
            if r is None:
                raise ValueError(f"decref of unallocated page {p}")
            if r == 1:
                del self._refs[p]
                self._free.append(p)
                freed.append(p)
            else:
                self._refs[p] = r - 1
        return freed

    def recycle(self, pages) -> int:
        """A :meth:`decref` for pages whose positions fell out of every
        live window, tallied in :attr:`recycled_total`. Returns the
        number of pages freed."""
        freed = len(self.decref(pages))
        self.recycled_total += freed
        return freed

    # --- integrity ---

    def check(self) -> None:
        """Invariant sweep: refcounts positive, the free list disjoint
        from the allocated set and without the trap page, and the two
        together covering the capacity exactly."""
        free = set(self._free)
        problems = [
            msg for ok, msg in (
                (all(r > 0 for r in self._refs.values()), "non-positive ref"),
                (len(free) == len(self._free), "duplicate page in free list"),
                (0 not in free and 0 not in self._refs, "trap page leaked"),
                (not free & set(self._refs), "page both free and allocated"),
                (len(free) + len(self._refs) == self.capacity, "pages lost"),
            ) if not ok
        ]
        if problems:
            raise AssertionError("; ".join(problems))


def kv_token_bytes(cfg) -> int:
    """Device bytes one cached token row costs: K and V across all
    layers, the two f32 scale rows included on a quantized cache. Both
    layouts' resident-bytes figures share it, so the dense reservation
    and the paged pool mean the same bytes for bf16, f32 and int8 alike
    (the pool pages its scale planes on the codes' geometry). The
    aggregate across tensor-parallel shards."""
    per_elt = {"int8": 1.0, "int4": 0.5}.get(cfg.cache_quant)
    if per_elt is None:
        per_elt = cfg.dtype.itemsize
    nbytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * per_elt
    if cfg.cache_quant in ("int8", "int4"):
        nbytes += 2 * cfg.n_layers * cfg.n_kv_heads * 4  # f32 scales
    return int(nbytes)


def kv_shard_token_bytes(cfg) -> int:
    """Per-shard bytes of one cached token row under tensor-parallel
    serving (the cache shards on the KV-head axis, scale planes
    included); :func:`kv_token_bytes` at ``tp=1``."""
    return kv_token_bytes(cfg) // max(1, getattr(cfg, "tp", 1))


# ---------------- KV page transfer wire format ----------------
#
# A request's cache pages travel from the replica that prefilled it to
# another that continues it (``ContinuousBatcher.export_kv_pages`` ->
# ``submit(kv_pages=...)``; the server's ``POST /v1/kv/export/{rid}``).
# The unit is the pool page: codes and, quantized, the scale planes, each
# plane ``(L, n_pages, page_size, Hkv, d)``. The blob is the reference's,
# byte for byte: self-describing (geometry, quant mode, per-plane shape
# and dtype), JSON-safe (base64 payloads), version 1, so a blob packed by
# either package unpacks in the other.
#
# Planes are CPU tensors. numpy cannot name bfloat16, so its payload is
# the tensor's raw little-endian bytes. An int4 plane is the reference's
# ``jnp.int4`` layout: one code a byte, last dimension ``hd``, the code in
# the low nibble as two's complement with the high nibble zero (-3 is
# 0x0d). In this package such a plane is an int8 tensor of codes in
# [-8, 7]: the pool's packed uint8 ``(..., hd / 2)`` is unpacked for the
# wire and packed again on install (``kv_wire_planes`` /
# ``kv_pool_planes``), so int4's wire carries twice the pool's code bytes.

KV_WIRE_VERSION = 1

#: wire dtype name -> the torch dtype its planes decode to (an int4 plane
#: decodes to int8 codes, one a byte as on the wire)
_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int8": torch.int8,
                "int4": torch.int8}
_WIRE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16", torch.int8: "int8"}


def _wire_dtype(name: str) -> torch.dtype:
    """Resolve a wire dtype name (the names a cache plane can carry)."""
    dt = _WIRE_DTYPES.get(name)
    if dt is None:
        raise ValueError(f"kv wire blob names unknown dtype {name!r}")
    return dt


def _plane_dtype_name(name: str, x: torch.Tensor, cache_quant) -> str:
    """The wire dtype of plane ``name``: an int4 cache's k/v planes are
    int4 codes (int8 here), every other plane its tensor's dtype."""
    if cache_quant == "int4" and name in ("k", "v"):
        if x.dtype != torch.int8:
            raise ValueError(
                f"int4 plane {name!r} must hold int8 codes (one a byte), "
                f"got {x.dtype}")
        return "int4"
    wire = _WIRE_NAMES.get(x.dtype)
    if wire is None:
        raise ValueError(f"kv plane {name!r} has dtype {x.dtype}, which the "
                         "wire cannot carry")
    return wire


def pack_kv_wire(planes: dict, *, page_size: int, cache_quant,
                 tokens: int) -> dict:
    """Serialize exported pool pages into a self-describing, JSON-safe
    wire blob. ``planes`` maps cache plane names (k/v and, quantized,
    k_scale/v_scale) to CPU tensors of shape ``(L, n_pages, page_size,
    Hkv, d)`` (an int4 cache's k/v as int8 codes, :func:`kv_wire_planes`);
    ``tokens`` is the count of valid leading rows (the importer checks it
    against the folded prompt it is asked to install under)."""
    n_pages = 0
    out = {}
    for name, x in planes.items():
        dtype = _plane_dtype_name(name, x, cache_quant)
        x = x.detach().cpu().contiguous()
        n_pages = int(x.shape[1])
        raw = x.view(torch.uint8)
        if dtype == "int4":
            raw = raw & 0x0F  # the code's low nibble, the high one zero
        out[name] = {
            "shape": [int(d) for d in x.shape],
            "dtype": dtype,
            "data": base64.b64encode(raw.numpy()).decode("ascii"),
        }
    return {
        "version": KV_WIRE_VERSION,
        "layout": "paged",
        "page_size": int(page_size),
        "cache_quant": cache_quant,
        "tokens": int(tokens),
        "n_pages": n_pages,
        "planes": out,
    }


def unpack_kv_wire(blob, *, pin_memory: bool = False) -> "tuple[dict, dict]":
    """Decode a :func:`pack_kv_wire` blob into ``(meta, planes)`` with
    CPU tensors (each decoded straight into pinned memory with
    ``pin_memory``, so a host-to-device copy of it need not wait),
    validating internal consistency (version, layout, payload sizes
    against the declared shapes and dtypes). Compatibility with a
    receiving pool (page size, quant mode, plane geometry) is the
    batcher's job: it knows its own cache."""
    if not isinstance(blob, dict) or "planes" not in blob:
        raise ValueError(
            "kv_pages is not a KV wire blob (expected the dict "
            "pack_kv_wire builds, with a 'planes' mapping)"
        )
    if blob.get("version") != KV_WIRE_VERSION:
        raise ValueError(
            f"unsupported KV wire version {blob.get('version')!r} "
            f"(this build speaks version {KV_WIRE_VERSION})"
        )
    if blob.get("layout") != "paged":
        raise ValueError(
            f"KV wire layout {blob.get('layout')!r} is not 'paged': "
            "only paged pools export/import pages"
        )
    n_pages = int(blob.get("n_pages", 0))
    planes = {}
    for name, p in blob["planes"].items():
        name_dt = p["dtype"]
        dt = _wire_dtype(name_dt)
        shape = tuple(int(d) for d in p["shape"])
        if len(shape) != 5 or shape[1] != n_pages:
            raise ValueError(
                f"kv wire plane {name!r} has shape {shape}; expected "
                f"5-d (L, n_pages={n_pages}, page_size, Hkv, d)"
            )
        raw = np.frombuffer(base64.b64decode(p["data"]), np.uint8)
        itemsize = 1 if name_dt == "int4" else dt.itemsize
        want = itemsize * math.prod(shape)
        if raw.size != want:
            raise ValueError(
                f"kv wire plane {name!r}: payload is {raw.size} bytes "
                f"but shape {shape} / dtype {name_dt} needs {want}"
            )
        buf = torch.empty(want, dtype=torch.uint8,
                          pin_memory=pin_memory and name_dt != "int4")
        if name_dt == "int4":
            # sign-extend the low nibble: (b << 4) as int8, shifted back
            raw = np.right_shift((raw << 4).view(np.int8), 4).view(np.uint8)
        buf.numpy()[:] = raw
        planes[name] = buf.view(dt).reshape(shape)
    meta = {k: v for k, v in blob.items() if k != "planes"}
    return meta, planes


def kv_wire_rows(name: str, leaf: torch.Tensor, cache_quant) -> tuple:
    """``(row shape, wire dtype)`` of a pool plane's pages on the wire:
    the plane's shape without its page axis, ``(L, page_size, Hkv, d)``
    (an int4 cache's k/v at ``d = hd``, one code a byte), and the dtype
    name a blob must declare for it."""
    rows = (leaf.shape[0], *leaf.shape[2:])
    if cache_quant == "int4" and name in ("k", "v"):
        return (*rows[:-1], 2 * rows[-1]), "int4"
    return tuple(rows), _WIRE_NAMES[leaf.dtype]


def kv_wire_planes(planes: dict, cache_quant) -> dict:
    """A pool's planes (as exported from its pages) -> the wire's: an
    int4 cache's packed uint8 k/v unpacked to one int8 code a byte."""
    if cache_quant != "int4":
        return dict(planes)
    return {name: unpack_int4(x) if name in ("k", "v") else x
            for name, x in planes.items()}


def kv_pool_planes(planes: dict, cache_quant) -> dict:
    """The wire's planes -> a pool's (the inverse of
    :func:`kv_wire_planes`): int4 codes packed two a byte."""
    if cache_quant != "int4":
        return dict(planes)
    return {name: pack_int4(x) if name in ("k", "v") else x
            for name, x in planes.items()}
