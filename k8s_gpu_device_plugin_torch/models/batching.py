"""Continuous batching for serving: slots, chunked prefill, decode.

Port of ``k8s_gpu_device_plugin_tpu/models/batching.py``: the dense and
the paged KV layout (bf16/f32, int8 codes or packed int4 codes; float or
weight-only int8/int4 quantized params), chunked prefill
(``prefill_chunk`` / ``prefill_finish``), FIFO admission and the
synchronous step loop (the reference's ``pipeline_depth=0`` semantics).
A slot is one concurrent sequence: on the dense layout its reserved
cache rows, on the paged one a page-table row over a shared pool
(``models/paging.py``), reserved at admission for the request's worst
case and released when it retires or is cancelled. Every slot decodes
at its own absolute position, and the decode step never changes shape
(empty slots compute and discard). The device state
(:class:`BatchState`) is updated in place; the host-side
:class:`ContinuousBatcher` owns the queue, the slot assignment, the page
pool and the per-request budgets.

Constructor and ``submit`` arguments the reference has and the port does
not serve yet (adapters, prefix cache, scheduler, tensor parallelism,
the pipelined loop, fault injection, ...) are refused when set, never
ignored; so is the paged layout under a sliding window (incremental
reservation and page recycling are not ported yet).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace

import torch

from k8s_gpu_device_plugin_torch.models.generate import KVCache, _forward_cached
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig
from k8s_gpu_device_plugin_torch.models.paging import PagePool, kv_token_bytes
from k8s_gpu_device_plugin_torch.models.quantized_serving import (
    check_cache_quant_kv_layout,
    resident_bytes,
    weight_quant_of,
)
from k8s_gpu_device_plugin_torch.models.sampling import (
    Sampler,
    sample_and_mark_dyn,
    sampler_knobs,
    token_logprob,
)
from k8s_gpu_device_plugin_torch.ops.attention import attention_backend_plan
from k8s_gpu_device_plugin_torch.utils.log import get_logger

#: the reference's prompt bucket ladder (bucketed prefill is not ported;
#: kept so callers can name the same boundaries)
DEFAULT_PROMPT_BUCKETS: tuple[int, ...] = (32, 64, 128, 256, 512, 1024)

# the reference's ContinuousBatcher arguments outside this slice, with the
# value that means "not used"; anything else is refused
_UNSERVED_INIT = {
    "prompt_buckets": DEFAULT_PROMPT_BUCKETS,
    "metrics": None,
    "adapters": None,
    "lora_slots": None,
    "adapter_cache_mb": 0,
    "pipeline_depth": 0,
    "trace_steps": False,
    "prefix_cache": None,
    "prefill_reserve_chunks": 2,
    "scheduler": None,
    "tp": None,
    "attribution": None,
    "mfu": None,
    "faults": None,
    "devices": None,
}
_UNSERVED_SUBMIT = {
    "prefix": None,
    "adapter": -1,
    "logit_bias": None,
    "tenant": "default",
    "priority": 1,
    "deadline_ms": None,
    "resume_out": None,
    "resume_logp": None,
    "kv_pages": None,
}


def _refuse(what: str, given: dict, unserved: dict) -> None:
    for name, value in given.items():
        if name not in unserved:
            raise TypeError(f"{what} got an unexpected argument {name!r}")
        if value != unserved[name]:
            raise NotImplementedError(
                f"{what}: {name}={value!r} is not served by the PyTorch port "
                f"yet (leave it at {unserved[name]!r})"
            )


@dataclass
class BatchState:
    """Device-side state of the serving batch, updated in place."""

    cache: KVCache
    lengths: torch.Tensor     # (B,) int32: valid cache rows per slot
    last_token: torch.Tensor  # (B,) int64: input to the next decode step
    active: torch.Tensor      # (B,) bool: slot is mid-generation
    presence: torch.Tensor    # (B, V) bool: repetition-penalty context
    budget: torch.Tensor      # (B,) int32: tokens the slot may still emit
    # paged layout only (None on the dense one): per-slot page tables
    # mapping virtual position p to pool page pages[slot, p // ps]
    # (models/paging.py owns the allocation). A row changes only at
    # admission, so the steady decode loop uploads nothing. Entry 0 is
    # the trap page: an unset row is harmlessly readable.
    pages: "torch.Tensor | None" = None  # (B, max_len // page_size) int32


def init_batch_state(cfg: LlamaConfig, n_slots: int, max_len: int,
                     device: "str | torch.device",
                     n_pages: int = 0) -> BatchState:
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    paged = cfg.kv_layout == "paged"
    return BatchState(
        cache=(KVCache.init_paged(cfg, n_pages, cfg.kv_page_size, device)
               if paged else KVCache.init(cfg, n_slots, max_len, device)),
        lengths=zeros((n_slots,), torch.int32),
        last_token=zeros((n_slots,), torch.int64),
        active=zeros((n_slots,), torch.bool),
        presence=zeros((n_slots, cfg.vocab_size), torch.bool),
        budget=zeros((n_slots,), torch.int32),
        pages=(zeros((n_slots, max_len // cfg.kv_page_size), torch.int32)
               if paged else None),
    )


def decode_step(
    params: dict,
    state: BatchState,
    allowed: torch.Tensor,    # (B,) bool: running-set membership
    eos_id: int,              # -1 disables EOS stopping
    cfg: LlamaConfig,
    knobs: torch.Tensor,      # (B, 4) per-slot sampler knobs
    generator: torch.Generator,
    row_generators: "list[torch.Generator | None] | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One token for every slot; inactive slots compute and discard.
    Updates ``state`` in place and returns (emitted (B,) int64 — -1 for
    slots that were not active — and logprobs (B,) f32).

    Inactive slots must not write at their stale lengths: a neighbour
    mid-chunked-prefill may own that row. Their writes go to the last
    cache row instead, which any sequence attends only at
    ``q_pos >= max_len - 1``, after its own decode step overwrote it.
    On the paged layout a retired slot's stale table may name pages since
    reallocated to a live neighbour, so an inactive slot's whole table
    row is redirected to the trap page 0 (never allocated, never attended
    unmasked). The masked table is built on the device: the step uploads
    nothing."""
    was_active = state.active & allowed & (state.budget > 0)
    if cfg.kv_layout == "paged":
        cache_len = state.pages.shape[1] * cfg.kv_page_size
        pages = torch.where(was_active[:, None], state.pages,
                            torch.zeros_like(state.pages))
    else:
        cache_len = state.cache.k.shape[2]
        pages = None
    write_pos = torch.where(was_active, state.lengths,
                            torch.full_like(state.lengths, cache_len - 1))
    logits = _forward_cached(params, state.last_token[:, None], state.cache,
                             write_pos, cfg, pages=pages)[:, -1]
    tok, presence = sample_and_mark_dyn(logits, knobs, state.presence,
                                        generator, row_generators)
    logps = token_logprob(logits, tok)
    hit_eos = (tok == eos_id) & (eos_id >= 0)
    full = state.lengths + 1 >= cache_len
    budget = torch.where(was_active, state.budget - 1, state.budget)
    state.lengths = torch.where(was_active, state.lengths + 1, state.lengths)
    state.last_token = torch.where(was_active, tok, state.last_token)
    state.active = was_active & ~hit_eos & ~full & (budget > 0)
    state.presence = torch.where(was_active[:, None], presence, state.presence)
    state.budget = budget
    emitted = torch.where(was_active, tok, torch.full_like(tok, -1))
    return emitted, logps


def _slot_cache(state: BatchState, slot: int, cfg: LlamaConfig) -> dict:
    """The cache and table one slot's prefill runs against, as
    ``_forward_cached`` arguments: the slot's view of a dense cache, or
    the whole pool with the slot's table row (the row scopes both the
    scatter-writes and the reads)."""
    if cfg.kv_layout == "paged":
        return dict(cache=state.cache, pages=state.pages[slot:slot + 1])
    return dict(cache=state.cache.slot(slot), pages=None)


def prefill_chunk(params: dict, state: BatchState, chunk: torch.Tensor,
                  chunk_start: int, slot: int, cfg: LlamaConfig) -> None:
    """One intermediate prefill chunk (C real tokens) into ``slot``: runs
    against the slot's own cache rows, so it attends everything the slot
    prefilled so far and nothing of its neighbours. No sampling."""
    _forward_cached(params, chunk[None, :], length=chunk_start, cfg=cfg,
                    select_pos=0, **_slot_cache(state, slot, cfg))
    # the request's first chunk starts the presence row from zeros: a
    # reused slot must not leak its previous occupant's tokens
    row = (torch.zeros_like(state.presence[slot]) if chunk_start == 0
           else state.presence[slot])
    row = row.clone()
    row[chunk.long()] = True
    state.presence[slot] = row


def prefill_finish(
    params: dict, state: BatchState, chunk: torch.Tensor, chunk_start: int,
    prompt_len: int, slot: int, cfg: LlamaConfig, knobs: torch.Tensor,
    max_new: int, generator: torch.Generator,
) -> tuple[int, float]:
    """Final chunk: run it, sample the first generated token, activate
    the slot. Returns (token, logprob).

    The host schedules it at ``prompt_len - C`` for prompts of at least
    C tokens (all real; rows an earlier chunk wrote are recomputed to
    identical K/V), so the window always fits the slot. Only shorter
    prompts pad, and their padded rows lie at positions >= prompt_len,
    which decode overwrites before it attends them (on the paged layout
    the padded rows past the slot's reservation land in the trap page)."""
    c = chunk.shape[0]
    logits = _forward_cached(
        params, chunk[None, :], length=chunk_start, cfg=cfg,
        select_pos=prompt_len - 1 - chunk_start,
        **_slot_cache(state, slot, cfg),
    )[:, 0]
    seen = (torch.zeros_like(state.presence[slot]) if chunk_start == 0
            else state.presence[slot].clone())
    real = chunk[: min(c, prompt_len - chunk_start)].long()
    seen[real] = True
    tok, seen = sample_and_mark_dyn(logits, knobs[None, :], seen[None, :],
                                    generator)
    logp = token_logprob(logits, tok)
    state.lengths[slot] = prompt_len
    state.last_token[slot] = tok[0]
    state.active[slot] = True
    state.presence[slot] = seen[0]
    state.budget[slot] = max_new - 1
    return int(tok[0]), float(logp[0])


class RequestTooLargeError(ValueError):
    """A request no slot can ever hold: ``prompt + max_new`` exceeds the
    slot capacity, or its pages the whole pool. Carries the numbers for a
    structured refusal body."""

    def __init__(self, message: str, *, prompt_tokens: int, max_new: int,
                 limit: int):
        super().__init__(message)
        self.prompt_tokens = int(prompt_tokens)
        self.max_new = int(max_new)
        self.limit = int(limit)

    def body(self) -> dict:
        return {"prompt_tokens": self.prompt_tokens,
                "max_new": self.max_new, "limit": self.limit}


@dataclass
class _Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = field(default_factory=list)
    # log P(out[i]) under the raw model distribution, parallel to out
    out_logp: list[float] = field(default_factory=list)
    slot: int = -1
    # multi-token stop sequences (host-side suffix match; kept in out)
    stop: tuple[tuple[int, ...], ...] = ()
    sampler: "Sampler | None" = None
    # a seeded request's own generator: its i-th use is the i-th draw
    generator: "torch.Generator | None" = None
    t_submit: float = 0.0
    t_first_tok: float = 0.0
    # paged admission: pages reserved and not yet installed in a table
    # row; ``defer_counted`` counts one pool-pressure spell once
    new_pages: "list[int] | None" = None
    defer_counted: bool = False


class ContinuousBatcher:
    """Host-side orchestrator: request queue -> slots -> token streams.

    Usage::

        cb = ContinuousBatcher(params, cfg, n_slots=4, max_len=256)
        rid = cb.submit([1, 5, 7], max_new=32)
        results = cb.run()          # {rid: [tok, ...], ...}

    Each :meth:`step` admits what fits (FIFO), advances the oldest
    mid-prefill request by one chunk, then runs one decode step for the
    whole batch and retires requests on EOS, a stop sequence or their
    ``max_new`` budget.

    ``kv_layout='paged'`` (or a config that says so) serves from a pool
    of ``kv_pages`` pages of ``kv_page_size`` rows, the trap page
    included; ``kv_pages=0`` sizes it to what the dense layout reserves
    plus the trap page, so the layout alone never admits less. A request
    reserves ``ceil((prompt + max_new) / kv_page_size)`` pages at
    admission; when the free list is short it waits at the head of the
    queue until a retirement frees pages."""

    def __init__(
        self,
        params: dict,
        cfg: LlamaConfig,
        n_slots: int,
        max_len: int,
        sampler: "Sampler | None" = None,
        eos_id: "int | None" = None,
        chunked_prefill: int = 256,
        seed: int = 0,
        kv_layout: "str | None" = None,     # None = take cfg.kv_layout
        kv_page_size: "int | None" = None,  # None = take cfg.kv_page_size
        kv_pages: int = 0,  # paged pool size; 0 = dense-equivalent + trap
        **unserved,
    ):
        _refuse("ContinuousBatcher", unserved, _UNSERVED_INIT)
        # the layout rides in the config, which every step function reads
        if kv_layout is not None or kv_page_size is not None:
            cfg = replace(
                cfg,
                kv_layout=cfg.kv_layout if kv_layout is None else kv_layout,
                kv_page_size=(cfg.kv_page_size if kv_page_size is None
                              else int(kv_page_size)),
            )
        check_cache_quant_kv_layout(cfg)
        paged = cfg.kv_layout == "paged"
        if paged:
            if max_len % cfg.kv_page_size:
                raise ValueError(
                    f"kv_page_size={cfg.kv_page_size} must divide "
                    f"max_len={max_len}: the page table's virtual extent "
                    "is exactly the slot capacity"
                )
            if kv_pages < 0:
                raise ValueError(
                    f"kv_pages must be >= 0 (0 = dense-equivalent pool), "
                    f"got {kv_pages}: a negative value would silently "
                    "serve the default pool size"
                )
            if cfg.sliding_window > 0:
                raise NotImplementedError(
                    f"kv_layout='paged' with sliding_window="
                    f"{cfg.sliding_window}: incremental page reservation "
                    "and out-of-window recycling are not ported yet "
                    "(ROADMAP A6, A10); serve kv_layout='dense'"
                )
        elif kv_pages:
            raise ValueError(
                f"kv_pages={kv_pages} has no effect under kv_layout="
                "'dense' (the dense cache reserves n_slots * max_len rows)"
            )
        if chunked_prefill <= 0:
            raise NotImplementedError(
                "chunked_prefill=0 (bucketed prefill_insert) is not ported "
                "yet: pass chunked_prefill=C > 0"
            )
        if chunked_prefill > max_len:
            raise ValueError(
                f"chunked_prefill={chunked_prefill} exceeds max_len={max_len}"
            )
        self.device = params["embed"].device
        self.params = params
        # the weights' quantization and resident bytes (codes and scales
        # included), for /v1/health beside the KV residency
        self.weight_stats = {"quant": weight_quant_of(params),
                             "resident_bytes": resident_bytes(params)}
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.sampler = sampler or Sampler()
        self.eos_id = -1 if eos_id is None else int(eos_id)
        self.chunk = int(chunked_prefill)
        self.attn_plan = attention_backend_plan(
            device=self.device, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            kv_layout=cfg.kv_layout, page_size=cfg.kv_page_size,
            cache_quant=cfg.cache_quant, chunk=self.chunk,
            window=cfg.sliding_window,
        )
        for mode, plan in self.attn_plan.items():
            if plan["backend"] == "unsupported":
                raise ValueError(
                    f"{mode} attention cannot run on {self.device}: "
                    f"{plan['reason']}"
                )
            get_logger().info(
                "attention backend: %s -> %s (%s)", mode, plan["backend"],
                plan["reason"],
            )
        # paged KV: the host-side page pool (free list + refcounts)
        self.pool: "PagePool | None" = None
        self._slot_pages: dict[int, list[int]] = {}  # slot -> its page ids
        n_pages = 0
        if paged:
            per_slot = max_len // cfg.kv_page_size
            n_pages = int(kv_pages) if kv_pages > 0 else n_slots * per_slot + 1
            self.pool = PagePool(n_pages, cfg.kv_page_size)
        # refused or deferred paged admissions by reason; ``validate``
        # counts from request threads, hence the lock
        self._kv_rejections = {"pool_pressure": 0, "request_too_large": 0}
        self._kv_rejections_lock = threading.Lock()
        self.state = init_batch_state(cfg, n_slots, max_len, self.device,
                                      n_pages=n_pages)
        # unseeded draws of every slot come from this one generator
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.pending: list[_Request] = []
        self.running: dict[int, _Request] = {}     # slot -> decoding request
        self.prefilling: dict[int, _Request] = {}  # slot -> mid-prefill
        self._prefill_pos: dict[int, int] = {}     # slot -> next chunk start
        self.done: dict[int, list[int]] = {}
        self.done_requests: dict[int, _Request] = {}
        self._next_rid = 0
        # work counters; the seconds are host clock around work that ends
        # in a device sync, so each phase is charged only its own time
        self.decode_steps = 0
        self.decode_tokens = 0
        self.decode_s = 0.0
        self.prefill_chunks = 0
        self.prefill_s = 0.0
        # running-set caches, rebuilt on admit/retire/cancel only
        self._knobs_cache: "torch.Tensor | None" = None
        self._allowed_cache: "torch.Tensor | None" = None

    # --- admission rule ---

    def validate(self, prompt_len: int, max_new: int) -> None:
        """Raise ValueError iff ``submit`` of a prompt this long would."""
        if prompt_len < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if prompt_len + max_new > self.max_len:
            raise RequestTooLargeError(
                f"prompt {prompt_len} + max_new {max_new} exceeds slot "
                f"capacity {self.max_len}",
                prompt_tokens=prompt_len, max_new=max_new,
                limit=self.max_len,
            )
        if self.pool is not None:
            # the paged wall is the pool, not the slot: a request whose
            # worst case outsizes the whole pool can never be admitted
            # (transient pressure defers in _admit instead)
            need = self.pool.pages_for_tokens(
                self._kv_need_tokens(prompt_len, max_new))
            if need > self.pool.capacity:
                self._count_kv_rejection("request_too_large")
                raise RequestTooLargeError(
                    f"request needs {need} KV pages (prompt {prompt_len} "
                    f"+ max_new {max_new} @ page_size "
                    f"{self.pool.page_size}) but the pool holds "
                    f"{self.pool.capacity}; raise kv_pages or shrink "
                    "the request",
                    prompt_tokens=prompt_len, max_new=max_new,
                    limit=self.pool.capacity * self.pool.page_size,
                )

    def validate_prompt(self, prompt) -> list[int]:
        toks = [int(t) for t in prompt]
        bad = [t for t in toks if not 0 <= t < self.cfg.vocab_size]
        if bad:
            raise ValueError(
                f"prompt token {bad[0]} outside vocab [0, "
                f"{self.cfg.vocab_size})"
            )
        return toks

    @staticmethod
    def validate_seed(seed) -> "int | None":
        if seed is None:
            return None
        seed = int(seed)
        if not 0 <= seed < 2**31:
            raise ValueError(f"seed must be in [0, 2^31), got {seed}")
        return seed

    def submit(
        self,
        prompt: list[int],
        max_new: int,
        stop: "list[list[int]] | None" = None,
        sampler: "Sampler | None" = None,
        seed: "int | None" = None,
        **unserved,
    ) -> int:
        """Queue a request; returns its id."""
        _refuse("submit", unserved, _UNSERVED_SUBMIT)
        prompt = self.validate_prompt(prompt)
        self.validate(len(prompt), max_new)
        seed = self.validate_seed(seed)
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(
            rid, prompt, int(max_new),
            stop=tuple(tuple(int(t) for t in s) for s in (stop or ()) if s),
            sampler=sampler, t_submit=time.perf_counter(),
        )
        if seed is not None:
            req.generator = torch.Generator(device=self.device)
            req.generator.manual_seed(seed)
        self.pending.append(req)
        return rid

    # --- running-set caches ---

    def _req_knobs(self, req: _Request) -> torch.Tensor:
        return torch.tensor(sampler_knobs(req.sampler or self.sampler),
                            dtype=torch.float32, device=self.device)

    def _batch_knobs(self) -> torch.Tensor:
        if self._knobs_cache is None:
            rows = [sampler_knobs(self.sampler)] * self.n_slots
            for slot, req in self.running.items():
                if req.sampler is not None:
                    rows[slot] = sampler_knobs(req.sampler)
            self._knobs_cache = torch.tensor(rows, dtype=torch.float32,
                                             device=self.device)
        return self._knobs_cache

    def _batch_allowed(self) -> torch.Tensor:
        if self._allowed_cache is None:
            allowed = [slot in self.running for slot in range(self.n_slots)]
            self._allowed_cache = torch.tensor(allowed, dtype=torch.bool,
                                               device=self.device)
        return self._allowed_cache

    def _row_generators(self) -> list:
        return [
            self.running[s].generator if s in self.running else None
            for s in range(self.n_slots)
        ]

    def _invalidate_slot_caches(self) -> None:
        self._knobs_cache = None
        self._allowed_cache = None

    # --- paged-KV admission (no-ops on the dense layout) ---

    def _kv_need_tokens(self, prompt_len: int, max_new: int) -> int:
        """Worst-case cache rows one admission must cover: the paged
        reservation's size, shared by ``validate`` and ``_reserve_pages``
        so that a refusal at submit and a deferral at admission cannot
        disagree."""
        return prompt_len + max_new

    def _reserve_pages(self, req: _Request) -> bool:
        """Pool-pressure check and reservation for one admission. False
        defers: the request keeps the head of the queue and pages free
        as slots retire. One spell of waiting counts once."""
        need = self.pool.pages_for_tokens(
            self._kv_need_tokens(len(req.prompt), req.max_new))
        if need > self.pool.free_pages:
            if not req.defer_counted:
                req.defer_counted = True
                self._count_kv_rejection("pool_pressure")
                get_logger().debug(
                    "admission deferred: KV pool pressure (rid %d needs %d "
                    "pages, %d free)", req.rid, need, self.pool.free_pages,
                )
            return False
        req.defer_counted = False
        req.new_pages = self.pool.alloc(need)
        return True

    def _install_pages(self, req: _Request, slot: int) -> None:
        """Upload the slot's page-table row: the reserved pages, then
        zeros (the trap page). The one upload a request's table costs."""
        if slot in self._slot_pages:
            raise RuntimeError(f"slot {slot} still holds pages")
        ids, req.new_pages = req.new_pages, None
        row = ids + [0] * (self.state.pages.shape[1] - len(ids))
        self._slot_pages[slot] = ids
        self.state.pages[slot] = torch.tensor(row, dtype=torch.int32,
                                              device=self.device)

    def _release_slot_pages(self, slot: int) -> None:
        """Drop the slot's page references when its request retires or
        is cancelled. The table row stays as it is: the decode step masks
        an inactive slot's row to the trap page, and the next admission
        overwrites it."""
        if self.pool is None:
            return
        ids = self._slot_pages.pop(slot, None)
        if ids:
            self.pool.decref(ids)

    def _count_kv_rejection(self, reason: str) -> None:
        with self._kv_rejections_lock:
            self._kv_rejections[reason] += 1

    def kv_rejections(self) -> dict:
        """Paged admissions refused (``request_too_large``) or made to
        wait (``pool_pressure``, one per spell) so far."""
        with self._kv_rejections_lock:
            return dict(self._kv_rejections)

    def kv_stats(self) -> dict:
        """KV residency for ``/v1/health``: both layouts report
        ``reserved_bytes`` (the device memory the cache tensors hold,
        scale planes included), so they compare directly; paged adds the
        pool's occupancy and its internal fragmentation (allocated page
        capacity not covered by live tokens). A snapshot: the HTTP
        thread reads it while the engine thread admits and retires."""
        tb = kv_token_bytes(self.cfg)
        if self.pool is None:
            return {"layout": "dense",
                    "reserved_bytes": self.n_slots * self.max_len * tb}
        live = sum(len(r.prompt) + len(r.out)
                   for r in list(self.running.values()))
        live += sum(self._prefill_pos.get(s, 0) for s in list(self.prefilling))
        pool = self.pool
        cap_tokens = pool.in_use * pool.page_size
        return {
            "layout": "paged",
            "page_size": pool.page_size,
            "pages_total": pool.capacity,
            "pages_in_use": pool.in_use,
            "pages_free": pool.free_pages,
            "pages_in_use_peak": pool.peak_in_use,
            "fragmentation_pct": (
                100.0 * (1.0 - min(live, cap_tokens) / cap_tokens)
                if cap_tokens else 0.0
            ),
            "reserved_bytes": pool.n_pages * pool.page_size * tb,
            "in_use_bytes": cap_tokens * tb,
        }

    # --- the step loop ---

    def _admit(self) -> None:
        free = [s for s in range(self.n_slots)
                if s not in self.running and s not in self.prefilling]
        while free and self.pending:
            req = self.pending[0]
            if self.pool is not None and not self._reserve_pages(req):
                break  # head-of-line wait: pages free as slots retire
            self.pending.pop(0)
            req.slot = free.pop(0)
            if self.pool is not None:
                self._install_pages(req, req.slot)
            self.prefilling[req.slot] = req
            self._prefill_pos[req.slot] = 0

    def _prefill_one_chunk(self) -> None:
        """Advance the oldest mid-prefill request by one chunk; on its
        final chunk, sample the first token and move it to running."""
        if not self.prefilling:
            return
        slot = next(iter(self.prefilling))
        req = self.prefilling[slot]
        start = self._prefill_pos[slot]
        c = self.chunk
        plen = len(req.prompt)
        self.prefill_chunks += 1
        t0 = time.perf_counter()
        if start + c < plen:  # intermediate chunk, all real tokens
            chunk = torch.tensor(req.prompt[start:start + c],
                                 dtype=torch.int64, device=self.device)
            prefill_chunk(self.params, self.state, chunk, start, slot,
                          self.cfg)
            if self.device.type == "cuda":
                # nothing reads this chunk back: wait here, or its device
                # time would be charged to the next decode step
                torch.cuda.synchronize(self.device)
            self.prefill_s += time.perf_counter() - t0
            self._prefill_pos[slot] = start + c
            return
        fstart = max(0, plen - c)
        rest = req.prompt[fstart:]
        chunk = torch.tensor(rest + [0] * (c - len(rest)), dtype=torch.int64,
                             device=self.device)
        tok, logp = prefill_finish(
            self.params, self.state, chunk, fstart, plen, slot, self.cfg,
            self._req_knobs(req), req.max_new,
            req.generator or self.generator,
        )  # returns host numbers: the chunk is done on the device
        self.prefill_s += time.perf_counter() - t0
        del self.prefilling[slot], self._prefill_pos[slot]
        req.out.append(tok)
        req.out_logp.append(logp)
        req.t_first_tok = time.perf_counter()
        self.running[slot] = req
        self._invalidate_slot_caches()
        self._finish_if_done(req)

    def _decode_once(self) -> int:
        t0 = time.perf_counter()
        emitted, logps = decode_step(
            self.params, self.state, self._batch_allowed(), self.eos_id,
            self.cfg, self._batch_knobs(), self.generator,
            self._row_generators(),
        )
        emitted = emitted.tolist()  # the step's one device sync
        logps = logps.tolist()
        self.decode_steps += 1
        self.decode_s += time.perf_counter() - t0
        n = 0
        for slot, req in list(self.running.items()):
            tok = emitted[slot]
            if tok >= 0:
                n += 1
                req.out.append(tok)
                req.out_logp.append(logps[slot])
                self._finish_if_done(req)
        self.decode_tokens += n
        return n

    def _finish_if_done(self, req: _Request) -> None:
        """EOS, a stop sequence, or budget exhaustion retires the request
        and frees its slot (matched tokens stay in the output)."""
        hit_eos = self.eos_id >= 0 and req.out and req.out[-1] == self.eos_id
        hit_stop = any(
            len(req.out) >= len(st) and tuple(req.out[-len(st):]) == st
            for st in req.stop
        )
        if hit_eos or hit_stop or len(req.out) >= req.max_new:
            self._retire(req)

    def _retire(self, req: _Request) -> None:
        self.done[req.rid] = req.out
        self.done_requests[req.rid] = req
        if self.running.get(req.slot) is req:
            del self.running[req.slot]
            self._invalidate_slot_caches()
            self._release_slot_pages(req.slot)

    def cancel(self, rid: int) -> bool:
        """Retire ``rid`` wherever it lives (pending, mid-prefill or
        decoding), keeping the tokens it has. False for unknown or
        finished ids."""
        for i, req in enumerate(self.pending):
            if req.rid == rid:
                self.pending.pop(i)
                self._retire(req)
                return True
        for mapping in (self.prefilling, self.running):
            for slot, req in list(mapping.items()):
                if req.rid == rid:
                    del mapping[slot]
                    self._prefill_pos.pop(slot, None)
                    self._invalidate_slot_caches()
                    self._release_slot_pages(slot)
                    self._retire(req)
                    return True
        return False

    def step(self) -> int:
        """Admit what fits, advance at most one prefill chunk, then one
        decode step for the whole batch. Returns tokens emitted by the
        decode step."""
        self._admit()
        self._prefill_one_chunk()
        if self.running:
            return self._decode_once()
        return 0

    def run(self, max_steps: "int | None" = None) -> dict[int, list[int]]:
        """Drive until every submitted request finished (or max_steps)."""
        steps = 0
        while self.pending or self.running or self.prefilling:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return dict(self.done)
