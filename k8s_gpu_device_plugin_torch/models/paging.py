"""Host-side page pool for the paged KV cache (models/batching.py).

Port of ``k8s_gpu_device_plugin_tpu/models/paging.py``: ``PagePool``,
``kv_token_bytes`` and ``kv_shard_token_bytes``. The KV transfer wire
format (``pack_kv_wire``) is not ported yet (ROADMAP A10).

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
reserved here).

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
