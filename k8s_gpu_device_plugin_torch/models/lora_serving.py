"""Multi-LoRA serving: many adapters behind one continuous batcher.

Port of ``k8s_gpu_device_plugin_tpu/models/lora_serving.py``. Serving
keeps the base weights untouched and adds each target projection's
low-rank delta per row::

    y[b] = x[b] @ W + (x[b] @ A_n) @ B_n        n = adapter of row b

- Adapters are stacked on a leading axis after the layer axis:
  ``(L, N, d_in, R)`` / ``(L, N, R, d_out)`` per target (``lora_wq_a``,
  ...), so a layer's slice is ``(N, d_in, R)`` like every other layer
  leaf. Mixed ranks zero-pad to the largest R, a target an adapter does
  not carry is a zero block, and each adapter's ``alpha / rank`` is baked
  into its B in f32, then cast (:func:`stack_adapters`).
- Each row selects its adapter by a one-hot ``sel`` row over the stack
  (all zeros: the base model). :func:`lora_delta` folds ``sel`` into both
  stacks first, then computes the row's delta once; every term of the
  fold but one is an exact zero product, so the fold is exact in any
  precision and a base row's delta is exactly zero.

The batcher serves one of two modes (``models/batching.py``): dense-N,
every adapter in the stacks (the reference's bit-identity oracle), or
gathered, the default, where :class:`AdapterStore` holds the registry on
the host and an LRU-resident subset on the device, and the batcher copies
the at most K adapters its batch uses into fixed compact ``(L, K, ...)``
stacks. Both modes give the same bits: the fold picks the same block
either way.

Where the reference swaps immutable arrays under a jitted step, the port
serves a captured CUDA graph that reads fixed addresses. So the compact
stacks and the selection buffer are allocated once, a gather copies a
resident block into a slot of the stacks (``copy_``, on the engine's
stream, behind the step in flight), and an upload runs on a thread of its
own, from pinned host memory, on a CUDA stream of its own: the engine
thread never waits for a host-to-device copy.

The deltas are the products the reference leaves to XLA outside any
Pallas kernel (reference ``lora_serving.py:588-601``): plain ``torch``
products here. Their numerics are the reference's: the selection is f32
and the stacks the model's dtype, so JAX computes the whole delta in f32
and rounds it once to the activations' dtype before the add. The port
folds in the stacks' dtype (exact), widens only the folded per-row
factors, computes ``za`` and the delta in f32 and rounds the delta once.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import OrderedDict
from dataclasses import dataclass

import torch

from k8s_gpu_device_plugin_torch.device import resolve_device
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig
from k8s_gpu_device_plugin_torch.models.lora import (
    TARGETABLE,
    LoraConfig,
    init_lora_params,
)

# every stackable target, in stacking order; an adapter may carry any subset
_ALL_TARGETS = TARGETABLE


@dataclass(frozen=True)
class AdapterSet:
    """Stacked adapters ready to serve: ``names[i]`` is adapter index i
    (the index requests select by); ``leaves`` merge into
    ``params["layers"]``."""

    names: tuple[str, ...]
    leaves: dict

    @property
    def n(self) -> int:
        return len(self.names)

    def index_of(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(
                f"unknown adapter {name!r}; loaded: {list(self.names)}"
            ) from None


def _scaled_blocks(cfg: LlamaConfig, ab: dict, scale: float, rank_cap: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One adapter's factors for one target -> (A, B) in ``cfg.dtype``
    with ``scale`` baked into B in f32, zero-padded to ``rank_cap``."""
    r = ab["a"].shape[-1]
    a = ab["a"].to(cfg.dtype)
    b = (ab["b"].float() * scale).to(cfg.dtype)
    if r < rank_cap:  # zero-pad mixed ranks: adds exactly nothing
        a = torch.nn.functional.pad(a, (0, rank_cap - r))
        b = torch.nn.functional.pad(b, (0, 0, 0, rank_cap - r))
    return a, b


def stack_adapters(cfg: LlamaConfig,
                   adapters: "list[tuple[str, dict, LoraConfig]]"
                   ) -> AdapterSet:
    """[(name, lora_params, lora_cfg), ...] -> AdapterSet, on the
    factors' device. ``lora_params`` is ``{target: {"a", "b"}}``
    (``models/lora.py`` shapes); ranks may differ per adapter."""
    if not adapters:
        raise ValueError("stack_adapters needs at least one adapter")
    names = tuple(name for name, _, _ in adapters)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate adapter names: {names}")
    targets = sorted({t for _, lp, _ in adapters for t in lp},
                     key=_ALL_TARGETS.index)
    rmax = max(lp[t]["a"].shape[-1] for _, lp, _ in adapters for t in lp)
    L = cfg.n_layers
    leaves: dict = {}
    for t in targets:
        carried = [lp[t] for _, lp, _ in adapters if t in lp]
        d_in, d_out = carried[0]["a"].shape[1], carried[0]["b"].shape[2]
        dev = carried[0]["a"].device
        a_blocks, b_blocks = [], []
        for _, lp, lcfg in adapters:
            ab = lp.get(t)
            if ab is None:  # the adapter does not carry this target
                a_blocks.append(torch.zeros((L, d_in, rmax), dtype=cfg.dtype,
                                            device=dev))
                b_blocks.append(torch.zeros((L, rmax, d_out),
                                            dtype=cfg.dtype, device=dev))
                continue
            a, b = _scaled_blocks(cfg, ab, lcfg.scale, rmax)
            a_blocks.append(a.to(dev))
            b_blocks.append(b.to(dev))
        # (L, N, d_in, R) / (L, N, R, d_out)
        leaves[f"lora_{t}_a"] = torch.stack(a_blocks, dim=1)
        leaves[f"lora_{t}_b"] = torch.stack(b_blocks, dim=1)
    return AdapterSet(names=names, leaves=leaves)


def attach_adapters(params: dict, adapters: AdapterSet,
                    device: "torch.device | None" = None) -> dict:
    """Base params + stacked adapters -> serving params (a new layers
    dict; the base tree is not mutated), the stacks on ``device`` (the
    base params' when None)."""
    dev = device if device is not None else params["embed"].device
    return {**params, "layers": {
        **params["layers"],
        **{k: v.to(dev) for k, v in adapters.leaves.items()}}}


def _pad_factor_blocks(cfg: LlamaConfig, t: str, ab: dict, scale: float,
                       rank_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One adapter's factors for target ``t`` -> its padded, pre-scaled
    ``(L, d_in, rank_cap)`` / ``(L, rank_cap, d_out)`` host blocks: the
    same casts, scale bake and padding :func:`stack_adapters` applies, so
    a registered adapter's blocks are bit for bit the dense stack's slice
    for its index."""
    r = ab["a"].shape[-1]
    if r > rank_cap:
        raise ValueError(
            f"adapter rank {r} exceeds the store's rank cap {rank_cap} "
            "(fixed by the first registration; the compact stacks have "
            "one shape)"
        )
    a, b = _scaled_blocks(cfg, ab, scale, rank_cap)
    return a.cpu().contiguous(), b.cpu().contiguous()


class AdapterStore:
    """Host-side adapter registry and LRU device residency: the source
    the batcher's compact stacks are gathered from.

    Registered adapters live as padded, pre-scaled host blocks,
    ``(L, d_in, rank_cap)`` / ``(L, rank_cap, d_out)`` per target (the
    per-index slices of what :func:`stack_adapters` would build), pinned
    once the store is bound to a card. A subset is resident on the device
    under ``cache_bytes`` (0 = no limit: everything uploads when bound or
    registered), LRU-ordered by use. The batcher's admission gate calls
    :meth:`ensure_resident`; a miss starts the upload on a daemon thread
    and the request waits at the queue head.

    Registry indices are stable: :meth:`unregister` leaves a tombstone
    (the name frees, the index is never reused), because prefix-cache
    roots, queued requests and the scheduler's quotas key on the index.
    The target set and the rank cap freeze at the first registration: the
    compact stacks have one shape.

    Threads: the engine thread registers and gathers; upload threads
    touch ``_resident``, ``_inflight`` and the counters under ``_lock``;
    :meth:`stats` snapshots under it for HTTP readers."""

    #: bounded upload-latency ring for the p99 the stats report
    _UPLOAD_RING = 512

    def __init__(self, cfg: LlamaConfig, *, cache_bytes: int = 0):
        if cache_bytes < 0:
            raise ValueError(f"cache_bytes must be >= 0, got {cache_bytes}")
        self.cfg = cfg
        self.cache_bytes = int(cache_bytes)
        self.rank_cap: "int | None" = None     # frozen at first register
        self._targets: "tuple[str, ...] | None" = None
        self._dims: dict[str, tuple[int, int]] = {}  # target -> (in, out)
        self.adapter_bytes = 0        # one adapter's device bytes (padded)
        self._names: list = []        # index -> name, or None (tombstone)
        self._index: dict[str, int] = {}
        self._host: dict[int, dict[str, torch.Tensor]] = {}  # owner: engine
        self._resident: "OrderedDict[int, dict]" = OrderedDict()
        self._inflight: set[int] = set()
        self._protected: frozenset = frozenset()  # batch-active: never evicted
        self._lock = threading.Lock()
        self.device: "torch.device | None" = None  # bound by the batcher
        self.metrics = None
        # counters (under _lock where an upload thread writes them)
        self.uploads = 0
        self.upload_failures = 0
        self.evictions = 0
        self.misses = 0
        self.unregistered = 0
        self.over_budget_events = 0
        self._upload_ms: list[float] = []

    # --- registry (engine thread) -----------------------------------------

    @property
    def n_registered(self) -> int:
        return sum(1 for n in self._names if n is not None)

    @property
    def names_tuple(self) -> tuple:
        """Positional names for the batcher's ``adapter_names``: a
        tombstone renders as "" so live indices never shift (and a name
        lookup can never resolve to a dead index)."""
        return tuple(n if n is not None else "" for n in self._names)

    def index_of(self, name: str) -> int:
        idx = self._index.get(name)
        if idx is None:
            raise KeyError(
                f"unknown adapter {name!r}; registered: "
                f"{[n for n in self._names if n is not None]}"
            )
        return idx

    def is_registered(self, idx: int) -> bool:
        return 0 <= idx < len(self._names) and self._names[idx] is not None

    def register(self, name: str, lora_params: dict, lcfg) -> int:
        """Add one adapter (``{target: {"a", "b"}}`` factors) -> its
        index. The first registration freezes the target set, the rank
        cap and the dims; later adapters must fit inside them (an absent
        target is a zero block, a lower rank zero-pads)."""
        if not name:
            raise ValueError("adapter name must be non-empty")
        if name in self._index:
            raise ValueError(f"adapter {name!r} is already registered")
        if getattr(self.cfg, "n_experts", 0):
            bad = sorted(set(lora_params) & {"w1", "w2", "w3"})
            if bad:
                raise ValueError(
                    f"adapter {name!r} targets MoE mlp projections {bad}; "
                    "serving-side LoRA on MoE is attention-only"
                )
        if self._targets is None:
            targets = tuple(sorted(lora_params, key=_ALL_TARGETS.index))
            if not targets:
                raise ValueError(f"adapter {name!r} carries no targets")
            self._targets = targets
            self.rank_cap = max(int(ab["a"].shape[-1])
                                for ab in lora_params.values())
            for t in targets:
                ab = lora_params[t]
                self._dims[t] = (int(ab["a"].shape[1]), int(ab["b"].shape[2]))
        else:
            extra = sorted(set(lora_params) - set(self._targets))
            if extra:
                raise ValueError(
                    f"adapter {name!r} targets {extra} outside the store's "
                    f"frozen set {list(self._targets)} (fixed at the first "
                    "registration; the compact stacks have one shape)"
                )
        blocks: dict[str, torch.Tensor] = {}
        L = self.cfg.n_layers
        for t in self._targets:
            d_in, d_out = self._dims[t]
            ab = lora_params.get(t)
            if ab is None:
                a = torch.zeros((L, d_in, self.rank_cap), dtype=self.cfg.dtype)
                b = torch.zeros((L, self.rank_cap, d_out),
                                dtype=self.cfg.dtype)
            else:
                if (int(ab["a"].shape[1]), int(ab["b"].shape[2])) != \
                        (d_in, d_out):
                    raise ValueError(
                        f"adapter {name!r} target {t!r} dims "
                        f"{ab['a'].shape[1]}x{ab['b'].shape[2]} != the "
                        f"store's {d_in}x{d_out}"
                    )
                a, b = _pad_factor_blocks(self.cfg, t, ab, lcfg.scale,
                                          self.rank_cap)
            blocks[f"lora_{t}_a"] = a
            blocks[f"lora_{t}_b"] = b
        return self._register_blocks(name, blocks)

    def _on_card(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def pin_host(self) -> None:
        """Move every host block to page-locked memory (needs CUDA): the
        upload thread's copies then run asynchronously on its stream.
        Binding to a card does it; :meth:`fork` shares pinned blocks."""
        for idx, blocks in self._host.items():
            self._host[idx] = {k: v if v.is_pinned() else v.pin_memory()
                               for k, v in blocks.items()}

    def fork(self, *, cache_bytes: "int | None" = None) -> "AdapterStore":
        """A new store over this one's registry (the same host blocks,
        shared, not copied; the same indices and tombstones) with nothing
        resident and fresh counters: one registry behind several
        batchers, each with its own residency."""
        twin = AdapterStore(self.cfg, cache_bytes=self.cache_bytes
                            if cache_bytes is None else cache_bytes)
        twin.rank_cap, twin._targets = self.rank_cap, self._targets
        twin._dims = dict(self._dims)
        twin.adapter_bytes = self.adapter_bytes
        twin._names = list(self._names)
        twin._index = dict(self._index)
        twin._host = dict(self._host)
        return twin

    def _register_blocks(self, name: str, blocks: dict) -> int:
        if not self.adapter_bytes:
            self.adapter_bytes = sum(v.numel() * v.element_size()
                                     for v in blocks.values())
        idx = len(self._names)
        self._names.append(name)
        self._index[name] = idx
        self._host[idx] = blocks
        if self._on_card():
            self.pin_host()
        # no budget (or room to spare) and a bound device: resident now.
        # A synchronous upload at registration is control-plane work
        if self.device is not None and (
                self.cache_bytes == 0
                or (self.resident_count() + 1) * self.adapter_bytes
                <= self.cache_bytes):
            self.make_resident(idx)
        self._report_residency()
        return idx

    @classmethod
    def from_set(cls, cfg: LlamaConfig, adapters: AdapterSet, *,
                 cache_bytes: int = 0) -> "AdapterStore":
        """An AdapterSet's per-index slices -> a store (the blocks the
        dense stacks hold, bit for bit, so gathered and dense-N serving
        agree by construction)."""
        store = cls(cfg, cache_bytes=cache_bytes)
        leaves = adapters.leaves
        targets = tuple(sorted({k[len("lora_"):-2] for k in leaves},
                               key=_ALL_TARGETS.index))
        store._targets = targets
        store.rank_cap = int(leaves[f"lora_{targets[0]}_a"].shape[-1])
        for t in targets:
            store._dims[t] = (int(leaves[f"lora_{t}_a"].shape[2]),
                              int(leaves[f"lora_{t}_b"].shape[3]))
        for i, name in enumerate(adapters.names):
            store._register_blocks(name, {
                k: v[:, i].cpu().contiguous() for k, v in leaves.items()})
        return store

    def unregister(self, name: str) -> int:
        """Tombstone ``name``: its host blocks and any residency drop,
        the index stays burned. The batcher wraps this: it refuses while
        requests for the adapter are live and evicts its prefix root."""
        idx = self.index_of(name)
        with self._lock:
            if idx in self._protected:
                raise RuntimeError(
                    f"adapter {name!r} is batch-active; the batcher should "
                    "have refused this unregister"
                )
            # under the lock: an upload in flight for it then never
            # publishes (_upload checks its host blocks are still these)
            self._host.pop(idx, None)
            self._resident.pop(idx, None)
            self.unregistered += 1
        self._names[idx] = None
        del self._index[name]
        self._report_residency()
        return idx

    # --- residency --------------------------------------------------------

    def bind(self, device: torch.device, metrics=None) -> None:
        """The consuming batcher hands over its device and metrics sink;
        the host blocks are pinned (on a card) and the store warms:
        synchronous uploads in registration order until the budget (or
        the registry) is exhausted. A store outlives a crashed batcher
        (the supervisor's rebuild binds it again): the old batch's
        protected set is dropped, its residency kept."""
        self.device = torch.device(device)
        self.metrics = metrics
        with self._lock:
            self._protected = frozenset()
        if self._on_card():
            self.pin_host()
        budget = (self.cache_bytes // self.adapter_bytes
                  if self.cache_bytes and self.adapter_bytes
                  else len(self._names))
        for idx, name in enumerate(self._names):
            if name is None or self.resident_count() >= budget:
                continue
            self.make_resident(idx)
        self._report_residency()

    def resident_count(self) -> int:
        with self._lock:
            return len(self._resident)

    def uploads_in_flight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def is_resident(self, idx: int) -> bool:
        with self._lock:
            return idx in self._resident

    def make_resident(self, idx: int) -> None:
        """A synchronous upload: registration, binding and control-plane
        calls only (admission goes through :meth:`ensure_resident`)."""
        host = self._host.get(idx)
        if host is None:
            raise KeyError(f"adapter index {idx} is not registered")
        with self._lock:
            if idx in self._resident:
                self._resident.move_to_end(idx)
                return
        self._upload(idx, host)

    def ensure_resident(self, idx: int) -> bool:
        """The admission gate: True when resident (and touched), False on
        a miss, with the upload started on a daemon thread: the caller
        defers the request and polls again, it never waits."""
        host = self._host.get(idx)
        if host is None:
            raise KeyError(f"adapter index {idx} is not registered")
        with self._lock:
            if idx in self._resident:
                self._resident.move_to_end(idx)
                return True
            if idx in self._inflight:
                return False
            self._inflight.add(idx)
            self.misses += 1
        threading.Thread(target=self._upload, args=(idx, host, True),
                         name=f"adapter-upload-{idx}", daemon=True).start()
        return False

    def _copy_to_device(self, host: dict) -> dict:
        """Host blocks -> device blocks, complete when this returns. On a
        card: asynchronous copies from pinned memory on a stream of the
        uploading thread's own, then that stream's event waited on (by
        this thread only). The blocks are allocated on that stream; a
        gather that reads one on the engine's stream records it there
        (``record_stream``), so the allocator does not hand an evicted
        block to another upload before the copies queued behind it ran."""
        dev = self.device
        if dev.type != "cuda":
            return {k: v.to(dev, copy=True) for k, v in host.items()}
        with torch.cuda.device(dev):
            stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(stream):
                blocks = {k: v.to(dev, non_blocking=True)
                          for k, v in host.items()}
                done = torch.cuda.Event()
                done.record(stream)
            done.synchronize()
        return blocks

    def _upload(self, idx: int, host: dict, async_: bool = False) -> None:
        try:
            t0 = time.perf_counter()
            blocks = self._copy_to_device(host)
            ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self._inflight.discard(idx)
                if self._host.get(idx) is not host:
                    return  # unregistered while in flight: never resident
                self._resident[idx] = blocks
                self._resident.move_to_end(idx)
                self.uploads += 1
                self._upload_ms.append(ms)
                del self._upload_ms[:-self._UPLOAD_RING]
                self._evict_to_budget_locked(keep=idx)
            if self.metrics is not None:
                hook = getattr(self.metrics, "on_adapter_upload", None)
                if hook is not None:
                    hook(ms / 1e3)
            self._report_residency()
        except BaseException:
            with self._lock:
                self._inflight.discard(idx)
                self.upload_failures += 1
            if not async_:
                raise
            # a failed asynchronous upload shows as the request deferring
            # again: the next ensure_resident starts the upload anew (a
            # retry on the device, not a fallback); the raise would only
            # end this daemon thread
            traceback.print_exc()

    def _evict_to_budget_locked(self, keep: int) -> None:
        """LRU-evict residents until the byte budget holds; batch-active
        (protected) adapters and ``keep`` are exempt. If the exempt set
        alone overflows the budget, residency exceeds it (counted):
        evicting an adapter the batch decodes with would stall it."""
        if not self.cache_bytes or not self.adapter_bytes:
            return
        cap = max(1, self.cache_bytes // self.adapter_bytes)
        while len(self._resident) > cap:
            victim = next((i for i in self._resident
                           if i != keep and i not in self._protected), None)
            if victim is None:
                self.over_budget_events += 1
                return
            del self._resident[victim]
            self.evictions += 1

    # --- gather (engine thread) -------------------------------------------

    def compact_stacks(self, k: int, device: torch.device) -> dict:
        """Zero compact ``(L, K, d_in, R)`` / ``(L, K, R, d_out)`` stacks,
        allocated once by the batcher (before its decode graph is
        captured) and filled by :meth:`gather`."""
        L = self.cfg.n_layers
        out = {}
        for t in self._targets:
            d_in, d_out = self._dims[t]
            out[f"lora_{t}_a"] = torch.zeros(
                (L, k, d_in, self.rank_cap), dtype=self.cfg.dtype,
                device=device)
            out[f"lora_{t}_b"] = torch.zeros(
                (L, k, self.rank_cap, d_out), dtype=self.cfg.dtype,
                device=device)
        return out

    def gather(self, stacks: dict, fills: dict, active: tuple) -> None:
        """Copy each ``fills`` adapter (compact slot -> registry index)
        into its slot of ``stacks`` and mark ``active`` (the batch's
        adapters, a superset of the fills) protected from eviction. Every
        active adapter must be resident: the admission gate made it so.
        The copies are queued on the current stream, behind the step in
        flight, which still reads the stacks it was dispatched with."""
        with self._lock:
            missing = [i for i in active if i not in self._resident]
            if missing:
                raise RuntimeError(
                    f"gather of non-resident adapters {missing}: the "
                    "admission gate must ensure_resident first"
                )
            rows = {slot: self._resident[idx] for slot, idx in fills.items()}
            for i in active:
                self._resident.move_to_end(i)
            self._protected = frozenset(active)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        for slot, row in rows.items():
            for name, src in row.items():
                if stream is not None:
                    src.record_stream(stream)
                stacks[name][:, slot].copy_(src, non_blocking=True)

    def protect(self, active: tuple) -> None:
        """The batch's adapter set shrank (no copy needed): only
        ``active`` stays protected from eviction."""
        with self._lock:
            self._protected = frozenset(active)

    # --- observability ----------------------------------------------------

    def _report_residency(self) -> None:
        if self.metrics is None:
            return
        hook = getattr(self.metrics, "set_adapter_residency", None)
        if hook is not None:
            resident = self.resident_count()
            hook(self.n_registered, resident, resident * self.adapter_bytes)

    def stats(self) -> dict:
        """Snapshot for ``/v1/health`` (plain numbers copied under the
        lock: safe from any thread)."""
        with self._lock:
            ms = sorted(self._upload_ms)
            p99 = ms[max(0, int(len(ms) * 0.99) - 1)] if ms else 0.0
            return {
                "registered": self.n_registered,
                "resident": len(self._resident),
                "resident_bytes": len(self._resident) * self.adapter_bytes,
                "cache_bytes": self.cache_bytes,
                "adapter_bytes": self.adapter_bytes,
                "uploads": self.uploads,
                "upload_ms_p99": round(p99, 3),
                "evictions": self.evictions,
                "misses": self.misses,
                "unregistered": self.unregistered,
                "over_budget_events": self.over_budget_events,
                "upload_failures": self.upload_failures,
            }


def one_hot_sel(adapter: int, n: int) -> torch.Tensor:
    """Row selection vector (f32, host): index -> one-hot, -1 (the base
    model) -> zeros."""
    sel = torch.zeros((n,), dtype=torch.float32)
    if adapter >= 0:
        if adapter >= n:
            raise ValueError(f"adapter index {adapter} >= n_adapters {n}")
        sel[adapter] = 1.0
    return sel


def fold(sel: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
    """sel (B, N) one-hot or zero rows, stack (N, ...) -> (B, ...) f32:
    each row's block (zeros for a zero row). The product runs in the
    stack's dtype, where it is exact (one nonzero term a row); only the
    folded blocks are widened."""
    n = stack.shape[0]
    picked = sel.to(stack.dtype) @ stack.reshape(n, -1)
    return picked.reshape(sel.shape[0], *stack.shape[1:]).float()


def lora_delta(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               sel: torch.Tensor, hf: "torch.Tensor | None" = None
               ) -> torch.Tensor:
    """Per-row low-rank delta for one layer's target: h (B, T, d_in),
    a (N, d_in, R), b (N, R, d_out), sel (B, N) one-hot or zero rows ->
    (B, T, d_out) in h's dtype. The selection folds into both stacks
    first (exact), then ``za`` and the delta run in f32 and the delta is
    rounded once, as the reference's promotion computes it. ``hf`` is
    ``h`` in f32 when the caller shares it between targets."""
    za = torch.bmm(h.float() if hf is None else hf, fold(sel, a))
    return torch.bmm(za, fold(sel, b)).to(h.dtype)


def maybe_lora(h: torch.Tensor, layer: dict, target: str,
               sel: "torch.Tensor | None",
               hf: "torch.Tensor | None" = None) -> "torch.Tensor | None":
    """The decode path's hook: the target's delta when this layer carries
    stacked factors and a selection is threaded; None otherwise (the
    base path then runs exactly what it runs without adapters)."""
    if sel is None:
        return None
    a = layer.get(f"lora_{target}_a")
    if a is None:
        return None
    return lora_delta(h, a, layer[f"lora_{target}_b"], sel, hf)


def init_random_adapters(
    cfg: LlamaConfig, n: int, rank: int,
    targets: tuple = ("wq", "wk", "wv", "wo", "w1", "w2", "w3"), *,
    seed: int = 0, device: "str | torch.device | None" = "cuda",
) -> "list[tuple[str, dict, LoraConfig]]":
    """``n`` random adapters for load tests and the card's runs:
    ``[("adapter{i}", factors, LoraConfig(rank, alpha=2 * rank,
    targets)), ...]`` with a nonzero B (0.02 times a standard normal; a
    zero B would be a no-op delta), drawn on ``device`` from one
    generator seeded with ``seed``."""
    if getattr(cfg, "n_experts", 0):
        targets = tuple(t for t in targets if t in ("wq", "wk", "wv", "wo"))
    dev = resolve_device(device)
    lcfg = LoraConfig(rank=rank, alpha=2.0 * rank, targets=targets)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = []
    for i in range(n):
        lp = init_lora_params(cfg, lcfg, generator=gen, device=dev)
        for t in sorted(lp):
            b = lp[t]["b"]
            lp[t]["b"] = (0.02 * torch.randn(b.shape, dtype=torch.float32,
                                             device=dev, generator=gen)
                          ).to(b.dtype)
        out.append((f"adapter{i}", lp, lcfg))
    return out
