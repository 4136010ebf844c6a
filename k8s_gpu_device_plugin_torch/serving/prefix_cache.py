"""Automatic prefix caching: a radix tree over token ids that reuses the
KV rows of prompts the engine already prefilled.

Port of ``k8s_gpu_device_plugin_tpu/serving/prefix_cache.py``
(``prefix_kv_bytes``, ``PrefixCacheStats``, ``PrefixCache``, its spans
``prefix_match``, ``prefix_promote``, ``prefix_evict`` and its metrics
hooks). Plain Python over token ids; the only device work is the row
extraction the batcher hands to :meth:`PrefixCache.on_prefill_done`.

- The tree is keyed by ``(adapter, tokens)``: K/V rows depend on the
  weights that produced them. ``adapter=-1`` is the base model's root.
- Every request is matched at admission (``ContinuousBatcher._admit``):
  the longest cached prefix of its prompt becomes the request's prefix
  and only the suffix is chunk-prefilled.
- After a request's prefill completes the batcher offers its prompt back
  (``on_prefill_done``); prefixes are promoted at the batcher's
  ``prompt_buckets`` boundaries, so the tree's edges each span one
  boundary gap (root -> tokens[0:32] -> tokens[32:64] -> ...).
- Residency is bounded by a device byte budget (:func:`prefix_kv_bytes`)
  with LRU eviction. On the dense layout an entry holds its own row copy;
  on the paged one it holds a pool reference on each page it spans
  (``batching.PagedPrefixState``), given back through ``release_entry``.
  Under tensor-parallel serving (``cfg.tp`` > 1) a dense entry holds one
  row copy a shard (a ``generate.ShardedKVCache``, each shard its own
  heads) and a paged one the same page ids, which mean the same page on
  every shard; entries are bound to the tp they were made under.

``min_hits=1`` promotes every completed prefill; ``min_hits=N`` waits for
N sightings of a boundary. An eviction drops the entry from the tree
only: a request that already matched it holds its own reference (the
dense rows, or the page pins the batcher took at match time), so the
streams with the cache on equal the streams with it off bit for bit.

Single-threaded: every mutating call happens on the engine thread.
``stats`` is read by the HTTP thread as plain counters.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from k8s_gpu_device_plugin_torch.models.batching import (
    PrefixState,
    effective_prefix_reuse,
)
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig
from k8s_gpu_device_plugin_torch.models.paging import kv_token_bytes
from k8s_gpu_device_plugin_torch.obs.trace import get_tracer


def prefix_kv_bytes(cfg: LlamaConfig, p: int) -> int:
    """Device bytes a ``p``-token cached prefix occupies: K and V rows in
    the cache's storage (bf16/f32 rows, int8 codes, or int4 codes packed
    two per byte) plus the f32 scale planes of a quantized cache, as
    :func:`~.paging.kv_token_bytes` counts them, so ``--prefixCacheMB``
    means the same bytes whatever the cache type. Under the paged layout
    an entry pins whole pool pages, so ``p`` rounds up to the page
    boundary. A per-entry charge: nested entries promoted from one prompt
    share pages and each is charged for every page it pins, so the
    cache-wide sum bounds the distinct pages it holds from above. Under
    tensor-parallel serving it is the aggregate over the shards (each
    holds ``1 / tp`` of it), so ``--prefixCacheMB`` keeps meaning the
    whole cache's bytes."""
    if getattr(cfg, "kv_layout", "dense") == "paged":
        ps = cfg.kv_page_size
        p = -(-p // ps) * ps
    return p * kv_token_bytes(cfg)


class _Node:
    """One radix-tree node at a bucket-boundary depth. ``span`` is the
    edge label from the parent (the tokens between the two boundaries);
    ``entry`` is the materialized prefix when this boundary has been
    promoted, None while it is only being hit-counted."""

    __slots__ = ("span", "parent", "children", "entry", "entry_bytes",
                 "hits", "depth")

    def __init__(self, span: tuple, parent: "_Node | None", depth: int):
        self.span = span
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.entry = None
        self.entry_bytes = 0
        self.hits = 0
        self.depth = depth


@dataclass
class PrefixCacheStats:
    """Plain counters, exposed on ``/v1/health`` as ``prefix_cache``."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    promotions: int = 0
    tokens_saved: int = 0
    resident_bytes: int = 0
    entries: int = 0
    nodes: int = 0

    def as_dict(self) -> dict:
        d = {k: getattr(self, k) for k in (
            "hits", "misses", "evictions", "promotions", "tokens_saved",
            "resident_bytes", "entries", "nodes",
        )}
        total = self.hits + self.misses
        d["hit_rate"] = self.hits / total if total else 0.0
        return d


@dataclass
class PrefixCache:
    """Adapter-keyed radix index of prefilled prefixes under an LRU byte
    budget. The batcher is the only caller: ``match`` at admission,
    ``on_prefill_done`` after each completed prefill."""

    cfg: LlamaConfig
    buckets: tuple[int, ...]
    budget_bytes: int
    #: promotion policy: 1 = every completed prefill's boundaries are
    #: materialized, N = only after N sightings
    min_hits: int = 1
    #: the batcher's chunked-prefill size, bound by the batcher at
    #: construction. Savings are whole chunks (the scheduler dispatches
    #: fixed-C chunks from the prefix boundary and the same finish chunk
    #: either way: ``effective_prefix_reuse``), so a match that skips no
    #: dispatch is refused. 0 = uncapped.
    chunk: int = 0
    #: a duck-typed metrics hook (``on_prefix_hit``, ``on_prefix_miss``,
    #: ``on_prefix_evict``, ``set_prefix_resident_bytes``), or None
    metrics: object = None
    #: entry constructor, rebound by a paged batcher (its extractor
    #: returns page ids and its entries are ``PagedPrefixState``)
    entry_factory: object = PrefixState
    #: eviction hook, bound by a paged batcher: an evicted entry's page
    #: references return to the pool (a dense entry's rows are freed
    #: when the last reference to them goes)
    release_entry: object = None
    #: host-memory backstop for the hit-counting nodes: past it new
    #: prompts stop growing the tree
    max_nodes: int = 65536
    stats: PrefixCacheStats = field(default_factory=PrefixCacheStats)

    def __post_init__(self):
        self.buckets = tuple(sorted(set(int(b) for b in self.buckets)))
        if not self.buckets:
            raise ValueError("prefix cache needs a non-empty bucket ladder")
        if self.min_hits < 1:
            raise ValueError(f"min_hits must be >= 1, got {self.min_hits}")
        self._roots: dict[int, _Node] = {}
        self._lru: "OrderedDict[_Node, None]" = OrderedDict()
        self._tracer = get_tracer()

    # --- submit side ---

    def match(self, tokens, adapter: int = -1, count: bool = True):
        """Longest cached prefix of ``tokens`` under ``adapter``, as
        ``(entry, matched_len)``, or None. The match is capped at
        ``len(tokens) - 1`` (one suffix token must remain for the finish
        chunk to sample from); prompts no longer than ``chunk`` never
        match, and neither does a prefix that skips no chunk dispatch.
        ``count=False`` looks up without recording the hit or miss: the
        paged batcher records it with :meth:`record_match` only when the
        request takes a slot (a deferred request may still be
        cancelled)."""
        node = self._roots.get(adapter)
        best: _Node | None = None
        depth = 0
        if node is not None and len(tokens) > self.chunk:
            cap = len(tokens) - 1
            for b in self.buckets:
                if b > cap:
                    break
                child = node.children.get(tuple(tokens[depth:b]))
                if child is None:
                    break
                node, depth = child, b
                if node.entry is not None:
                    best = node
        if best is not None and self.effective_reuse(
            best.depth, len(tokens)
        ) <= 0:
            best = None
        if best is None:
            if count:
                self.record_match(None, len(tokens), adapter)
            return None
        # warm even on an uncounted lookup: a deferred request is about
        # to alias the entry
        self._lru.move_to_end(best)
        if count:
            self.record_match(best.depth, len(tokens), adapter)
        return best.entry, best.depth

    def record_match(self, depth: "int | None", prompt_len: int,
                     adapter: int = -1) -> None:
        """Record one request's hit (``depth`` matched tokens) or miss
        (``depth=None``)."""
        if depth is None:
            self.stats.misses += 1
            self._hook("on_prefix_miss")
            return
        self.stats.hits += 1
        saved = self.effective_reuse(depth, prompt_len)
        self.stats.tokens_saved += saved
        self._hook("on_prefix_hit", saved)
        if self._tracer.enabled:
            self._tracer.span(
                "prefix_match", component="prefix_cache", matched=depth,
                saved=saved, prompt_len=prompt_len, adapter=adapter).end()

    def effective_reuse(self, matched: int, prompt_len: int) -> int:
        """This cache's view of :func:`effective_prefix_reuse`."""
        return effective_prefix_reuse(matched, prompt_len, self.chunk)

    # --- promotion side ---

    def on_prefill_done(self, tokens, adapter: int, extract) -> None:
        """A request's prefill just completed: walk (and grow) its
        boundary path, count the sightings, and materialize every
        boundary past ``min_hits`` that fits the budget. ``extract(p)``
        returns the slot's first ``p`` rows (dense) or the page ids that
        hold them (paged)."""
        if self.budget_bytes <= 0:
            return
        root = self._roots.get(adapter)
        if root is None:
            root = self._roots[adapter] = _Node((), None, 0)
            self.stats.nodes += 1
        node, depth = root, 0
        # one presence mask per walk, extended boundary by boundary
        presence_np = covered = None
        for b in self.buckets:
            if b > len(tokens):
                break
            span = tuple(tokens[depth:b])
            child = node.children.get(span)
            if child is None:
                if self.stats.nodes >= self.max_nodes:
                    return
                child = _Node(span, node, b)
                node.children[span] = child
                self.stats.nodes += 1
            node, depth = child, b
            node.hits += 1
            if node.entry is None and node.hits >= self.min_hits:
                if presence_np is None:
                    presence_np = np.zeros((self.cfg.vocab_size,), bool)
                    covered = 0
                presence_np[np.asarray(tokens[covered:b], np.int64)] = True
                covered = b
                self._materialize(node, tokens[:b], adapter, extract,
                                  presence_np)

    def _materialize(self, node: _Node, tokens, adapter: int, extract,
                     presence_np) -> None:
        nbytes = prefix_kv_bytes(self.cfg, node.depth)
        if nbytes > self.budget_bytes:
            return  # an uncacheable giant must not wipe the whole LRU
        while self.stats.resident_bytes + nbytes > self.budget_bytes:
            # keep=node: the prune cascade must not detach the node this
            # call is filling
            self._evict_lru(keep=node)
        rows = extract(node.depth)
        node.entry = self.entry_factory(
            rows=rows, tokens=tuple(tokens),
            # a copy on the rows' device: the walk goes on extending
            # presence_np for the next boundary
            presence=torch.from_numpy(presence_np.copy()).to(
                _device_of(rows)),
            adapter=adapter,
        )
        node.entry_bytes = nbytes
        self._lru[node] = None
        self.stats.promotions += 1
        self.stats.entries += 1
        self.stats.resident_bytes += nbytes
        self._report_residency()
        if self._tracer.enabled:
            self._tracer.span(
                "prefix_promote", component="prefix_cache",
                prefix_len=node.depth, bytes=nbytes, adapter=adapter,
                hits=node.hits).end()

    # --- eviction ---

    def reset(self) -> None:
        """Drop every node and entry WITHOUT the release hook: a paged
        entry's page ids index the pool of the batcher that promoted
        them, and once that pool is gone there is nothing to give them
        back to. Cumulative counters survive; residency zeroes."""
        self._roots.clear()
        self._lru.clear()
        self.stats.nodes = 0
        self.stats.entries = 0
        self.stats.resident_bytes = 0
        self._report_residency()

    def evict_adapter(self, adapter: int) -> int:
        """Drop one adapter's whole root (every entry and hit-counting
        node under it); returns the number of entries evicted. Entries
        release through the same hook as LRU eviction."""
        root = self._roots.pop(adapter, None)
        if root is None:
            return 0
        evicted = nodes = 0
        stack = [root]
        while stack:
            node = stack.pop()
            nodes += 1
            stack.extend(node.children.values())
            if node.entry is None:
                continue
            freed = node.entry_bytes
            if self.release_entry is not None:
                self.release_entry(node.entry)
            node.entry = None
            node.entry_bytes = 0
            self._lru.pop(node, None)
            evicted += 1
            self.stats.evictions += 1
            self.stats.entries -= 1
            self.stats.resident_bytes -= freed
            self._hook("on_prefix_evict", freed)
        self.stats.nodes -= nodes
        self._report_residency()
        if self._tracer.enabled:
            self._tracer.span(
                "prefix_evict_adapter", component="prefix_cache",
                adapter=adapter, entries=evicted, nodes=nodes).end()
        return evicted

    def evict_one(self) -> bool:
        """Evict the least recently used entry; False when the cache is
        empty. The paged batcher's pool-pressure valve: cached prefixes
        are reclaimable pool capacity."""
        if not self._lru:
            return False
        self._evict_lru()
        return True

    def _evict_lru(self, keep: "_Node | None" = None) -> None:
        node, _ = self._lru.popitem(last=False)
        freed, depth = node.entry_bytes, node.depth
        if self.release_entry is not None:
            # the page references go back BEFORE the tree forgets the
            # entry (requests that matched it hold their own pins)
            self.release_entry(node.entry)
        node.entry = None
        node.entry_bytes = 0
        self.stats.evictions += 1
        self.stats.entries -= 1
        self.stats.resident_bytes -= freed
        # prune entry-less leaves; ``keep`` guards the node a
        # _materialize in progress is about to fill
        while (
            node is not None and node is not keep and node.entry is None
            and not node.children and node.parent is not None
            and node.parent.children.get(node.span) is node
        ):
            del node.parent.children[node.span]
            self.stats.nodes -= 1
            node = node.parent
        self._report_residency()
        self._hook("on_prefix_evict", freed)
        if self._tracer.enabled:
            self._tracer.span("prefix_evict", component="prefix_cache",
                              prefix_len=depth, bytes=freed).end()

    def _report_residency(self) -> None:
        self._hook("set_prefix_resident_bytes", self.stats.resident_bytes,
                   self.stats.entries)

    def _hook(self, name: str, *args) -> None:
        fn = getattr(self.metrics, name, None) if self.metrics else None
        if fn is not None:
            fn(*args)


def _device_of(rows) -> torch.device:
    """Where an extracted entry lives: a dense entry's row tensors, or the
    CPU for a tuple of page ids (the batcher moves the presence row to
    its device when it aliases the entry)."""
    shards = getattr(rows, "shards", None)  # tp > 1: shard 0's device
    k = getattr(shards[0] if shards else rows, "k", None)
    return k.device if isinstance(k, torch.Tensor) else torch.device("cpu")
