"""Continuous batching for serving: slots, prefill, the decode loop.

Port of ``k8s_gpu_device_plugin_tpu/models/batching.py``: the dense and
the paged KV layout (bf16/f32, int8 codes or packed int4 codes; float or
weight-only int8/int4 quantized params), bucketed prefill-then-insert
(``prefill_insert``, ``chunked_prefill=0``, the default) and chunked
prefill (``prefill_chunk`` / ``prefill_finish``), FIFO admission,
per-request logit bias and seeds, the pipelined decode loop
(``pipeline_depth=1``, the default; 0 is the synchronous loop), shared
prefixes (a manual ``precompute_prefix`` or the automatic
``serving/prefix_cache.py``) and windowed paged serving. A slot is one
concurrent sequence: on the dense layout its reserved cache rows, on the
paged one a page-table row over a shared pool (``models/paging.py``),
reserved at admission for the request's worst case (under a sliding
window: for its first chunks, grown chunk by chunk, with pages that fall
out of the window recycled) and released when it retires or is
cancelled. Every slot decodes at its own absolute position, and the
decode step never changes shape (empty slots compute and discard).

The device state (:class:`BatchState`) and every per-slot input of the
decode step (membership mask, sampler knobs, the logit-bias plane, the
seeds, the EOS id) are persistent tensors updated in place: admission,
retirement, cancellation, page growth, aliasing, copy-on-write and
recycling write them, the steady decode loop uploads nothing. On a CUDA
device that lets the batcher capture the decode step once as a CUDA
graph (:class:`DecodeGraph`, the port's counterpart of the reference's
jitted step) and replay it every token; on the CPU, where the caller
asked for it, the step runs eagerly. Every write of the host's (table
rows, copied pages, presence rows) is queued on the stream the replays
run on, so it lands after the step in flight and before the next.

The pipelined loop dispatches step t+1 before it reads step t back, so
the host's per-token work overlaps the device's next step. Its rules
are the reference's: the in-flight step is flushed before an admission
that reuses one of its live slots, a slot retired or cancelled since the
dispatch (and a -1 sentinel) is skipped on readback, and when the
budgets show that the in-flight step retires every running request it
is read back without a dispatch ahead. Greedy and seeded streams are
the same bit for bit at either depth and with the prefix cache on or
off; so are unseeded ones as long as no admission waits on a retirement
(the pipeline sees a retirement one step later, so such an admission,
and the shared generator's draws behind it, come one step later).

Constructor and ``submit`` arguments the reference has and the port does
not serve yet (adapters, scheduler, tensor parallelism, fault injection,
KV page export and install, ...) are refused when set, never ignored.

The speculative batcher (``models/spec_batching.py``) is a subclass that
overrides the reference's seams: the prefill's chunk and finish
(``_apply_prefill_chunk``, ``_apply_prefill_finish``), the hook of a
scheduled chunked prefill (``_on_prefill_scheduled``), the step's device
and host halves (``_eager_step``, ``_apply_decode_result``), the
reservation's size (``_kv_need_tokens``) and the class flags the server
reads (``per_request_sampler``, ``per_request_bias``, ...).
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass, field, replace

import torch

from k8s_gpu_device_plugin_torch.models.generate import KVCache, _forward_cached
from k8s_gpu_device_plugin_torch.models.llama import (
    LlamaConfig,
    cast_params_for_compute,
)
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
from k8s_gpu_device_plugin_torch.ops import kernel_support
from k8s_gpu_device_plugin_torch.ops.attention import attention_backend_plan
from k8s_gpu_device_plugin_torch.utils.log import get_logger

#: the reference's prompt bucket ladder: a bucketed prefill pads the
#: prompt to the first bucket that holds it
DEFAULT_PROMPT_BUCKETS: tuple[int, ...] = (32, 64, 128, 256, 512, 1024)

# the reference's ContinuousBatcher arguments outside this slice, with the
# value that means "not used"; anything else is refused
_UNSERVED_INIT = {
    "metrics": None,
    "adapters": None,
    "lora_slots": None,
    "adapter_cache_mb": 0,
    "trace_steps": False,
    "scheduler": None,
    "tp": None,
    "attribution": None,
    "mfu": None,
    "faults": None,
    "devices": None,
}
_UNSERVED_SUBMIT = {
    "adapter": -1,
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


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


def effective_prefix_reuse(matched: int, prompt_len: int, chunk: int) -> int:
    """Prefill work a ``matched``-token prefix skips for a
    ``prompt_len``-token prompt under chunked prefill, in tokens of
    dispatched chunks. The scheduler dispatches fixed-C intermediate
    chunks from the prefix boundary and the same back-scheduled finish
    chunk either way, so the savings are whole skipped chunks: a 64-token
    match against chunk 256 skips nothing, a 256-token match skips one
    dispatch. The one definition of it: ``cached_tokens``, the
    ``prefix_reused`` count and the cache's ``tokens_saved`` all report
    it (``chunk=0`` returns ``matched``)."""
    if not chunk:
        return matched

    def n_chunks(start: int) -> int:
        # intermediate chunks dispatched from ``start``: one per C while
        # start + C < prompt_len
        return max(0, -(-(prompt_len - start) // chunk) - 1)

    return (n_chunks(0) - n_chunks(matched)) * chunk


@dataclass
class BatchState:
    """Device-side state of the serving batch. Every tensor is updated in
    place and never rebound, so a captured decode step reads and writes
    the same storage on every replay."""

    cache: KVCache
    lengths: torch.Tensor     # (B,) int32: valid cache rows per slot
    last_token: torch.Tensor  # (B,) int64: input to the next decode step
    active: torch.Tensor      # (B,) bool: slot is mid-generation
    presence: torch.Tensor    # (B, V) bool: repetition-penalty context
    budget: torch.Tensor      # (B,) int32: tokens the slot may still emit
    # the slot's request seed (-1 = unseeded) and its next draw index:
    # a seeded row's i-th token is draw i, counted on the device, so a
    # step dispatched ahead of the host's token count draws the true i
    seeds: torch.Tensor       # (B,) int32
    draws: torch.Tensor       # (B,) int32
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
        seeds=torch.full((n_slots,), -1, dtype=torch.int32, device=device),
        draws=zeros((n_slots,), torch.int32),
        pages=(zeros((n_slots, max_len // cfg.kv_page_size), torch.int32)
               if paged else None),
    )


def decode_step(
    params: dict,
    state: BatchState,
    allowed: torch.Tensor,    # (B,) bool: running-set membership
    eos_id: "int | torch.Tensor",  # -1 disables EOS stopping
    cfg: LlamaConfig,
    knobs: torch.Tensor,      # (B, 4) per-slot sampler knobs
    generator: torch.Generator,
    bias: "torch.Tensor | None" = None,   # (B, V) f32 per-slot logit bias
    seeds: "torch.Tensor | None" = None,  # (B,) int32, -1 = unseeded
) -> tuple[torch.Tensor, torch.Tensor]:
    """One token for every slot; inactive slots compute and discard.
    Updates every tensor of ``state`` in place (``copy_``) and returns
    (emitted (B,) int64 — -1 for slots that were not active — and
    logprobs (B,) f32). A seeded slot draws at ``state.draws``, which
    advances for every slot that emitted.

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
                                        generator, bias, seeds, state.draws)
    logps = token_logprob(logits, tok)
    hit_eos = (tok == eos_id) & (eos_id >= 0)
    full = state.lengths + 1 >= cache_len
    budget = torch.where(was_active, state.budget - 1, state.budget)
    state.lengths.copy_(torch.where(was_active, state.lengths + 1,
                                    state.lengths))
    state.last_token.copy_(torch.where(was_active, tok, state.last_token))
    state.active.copy_(was_active & ~hit_eos & ~full & (budget > 0))
    state.presence.copy_(torch.where(was_active[:, None], presence,
                                     state.presence))
    state.budget.copy_(budget)
    state.draws.copy_(torch.where(was_active, state.draws + 1, state.draws))
    emitted = torch.where(was_active, tok, torch.full_like(tok, -1))
    return emitted, logps


class DecodeGraph:
    """A decode step captured once as a CUDA graph and replayed for every
    token: the port's counterpart of the reference's jitted step. ``step``
    is a closure over persistent tensors only (the batch state, the
    per-slot inputs, the parameters) that runs :func:`decode_step` and
    returns its (emitted, logprobs), or a speculative round
    (``spec_batching.spec_decode_step``: emitted, counts, logprobs); a
    replay runs the same kernels on the same storage and leaves its
    results in :attr:`outputs`.

    The capture warms the step up twice on a side stream first; the
    caller must make that harmless (the batcher captures before any slot
    is allowed, so the warm-up only writes the trap rows). The unseeded
    generator is registered with the graph, so a replay advances its
    offset as an eager call would, and the warm-up's draws are rewound.
    Kernel wrappers count launches on the host, which a replay never
    reaches: the capture's counts are recorded (the capture itself
    launches nothing) and every replay adds them. A failed capture or
    replay raises; nothing falls back to the eager step."""

    def __init__(self, step, generator: torch.Generator,
                 device: torch.device):
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                f"torch {torch.__version__} has no "
                "CUDAGraph.register_generator_state: the decode step's "
                "unseeded draws cannot be captured")
        rewind = generator.get_state()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                step()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        generator.set_state(rewind)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        # the capture empties the allocator's cache before it starts: so
        # does the baseline, and what the capture reserves is its pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        with kernel_support.recording_launches() as launches:
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.outputs = step()
        torch.cuda.synchronize(device)
        #: device memory the capture reserved: the graph's private pool
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        #: kernel launches of one replay, by ``launch_counts()`` key
        self.launches = dict(launches)
        self.replays = 0

    def replay(self) -> tuple:
        self.graph.replay()
        kernel_support.count_replay(self.launches)
        self.replays += 1
        return self.outputs

    def stats(self) -> dict:
        return {"pool_bytes": self.pool_bytes, "replays": self.replays,
                "launches_per_replay": dict(self.launches)}


def _slot_cache(state: BatchState, slot: int, cfg: LlamaConfig) -> dict:
    """The cache and table one slot's prefill runs against, as
    ``_forward_cached`` arguments: the slot's view of a dense cache, or
    the whole pool with the slot's table row (the row scopes both the
    scatter-writes and the reads)."""
    if cfg.kv_layout == "paged":
        return dict(cache=state.cache, pages=state.pages[slot:slot + 1])
    return dict(cache=state.cache.slot(slot), pages=None)


def _activate(state: BatchState, slot: int, tok: torch.Tensor,
              seen: torch.Tensor, prompt_len: int, max_new: int) -> None:
    """A slot's first token is sampled (draw 0): it joins the decode."""
    state.lengths[slot] = prompt_len
    state.last_token[slot] = tok[0]
    state.active[slot] = True
    state.presence[slot] = seen[0]
    state.budget[slot] = max_new - 1
    state.draws[slot] = 1


def _insert_rows(state: BatchState, rows: KVCache, slot: int,
                 cfg: LlamaConfig) -> None:
    """Copy a single-row scratch cache's P rows (L, 1, P, H, d) into
    ``slot``, codes and scale planes alike: in place on the dense layout,
    through the slot's page table on the paged one (row i lands in page
    ``pages[slot, i // ps]`` at offset ``i % ps``; rows past the slot's
    reservation land in the trap page)."""
    p = rows.k.shape[2]
    if cfg.kv_layout == "paged":
        ps = cfg.kv_page_size
        idx = torch.arange(p, device=rows.k.device)
        pidx, off = state.pages[slot][idx // ps].long(), idx % ps
    for name in ("k", "v", "k_scale", "v_scale"):
        full, part = getattr(state.cache, name), getattr(rows, name)
        if full is None:  # an unquantized cache has no scale planes
            continue
        if cfg.kv_layout == "paged":
            full[:, pidx, off] = part[:, 0]
        else:
            full[:, slot, :p] = part[:, 0]


def prefill_insert(
    params: dict, state: BatchState, prompt: torch.Tensor, prompt_len: int,
    slot: int, cfg: LlamaConfig, knobs: torch.Tensor, max_new: int,
    generator: torch.Generator, bias: "torch.Tensor | None" = None,
    seeds: "torch.Tensor | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucketed prefill of one request into ``slot``: the prompt padded
    to its bucket P (``prompt`` (P,)) runs through a fresh single-row
    scratch cache of capacity P from position 0, only the last real
    position is projected, and the P rows are inserted into the slot
    (rows past ``prompt_len`` are never attended before decode overwrites
    them). The first token is sampled with the slot's ``bias`` (1, V) and
    ``seeds`` (1,) at draw 0, and the slot is activated. Returns (token
    (1,) int64, its logprob (1,) f32) on the device."""
    p = prompt.shape[0]
    scratch = KVCache.init(cfg, 1, p, prompt.device)
    logits = _forward_cached(params, prompt[None, :], scratch, 0, cfg,
                             select_pos=prompt_len - 1)[:, 0]
    seen = torch.zeros_like(state.presence[slot])
    seen[prompt[:prompt_len].long()] = True
    tok, seen = sample_and_mark_dyn(logits, knobs[None, :], seen[None, :],
                                    generator, bias, seeds)
    logp = token_logprob(logits, tok)
    _insert_rows(state, scratch, slot, cfg)
    _activate(state, slot, tok, seen, prompt_len, max_new)
    return tok, logp


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
    bias: "torch.Tensor | None" = None, seeds: "torch.Tensor | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Final chunk: run it, sample the first generated token with the
    slot's ``bias`` (1, V) and ``seeds`` (1,) at draw 0, activate the
    slot. Returns (token (1,) int64, its logprob (1,) f32) on the device.

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
                                    generator, bias, seeds)
    logp = token_logprob(logits, tok)
    _activate(state, slot, tok, seen, prompt_len, max_new)
    return tok, logp


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
    prompt: list[int]          # the full prompt (shared prefix + suffix)
    max_new: int
    out: list[int] = field(default_factory=list)
    # log P(out[i]) under the raw model distribution, parallel to out
    out_logp: list[float] = field(default_factory=list)
    slot: int = -1
    # multi-token stop sequences (host-side suffix match; kept in out)
    stop: tuple[tuple[int, ...], ...] = ()
    sampler: "Sampler | None" = None
    # OpenAI-style logit bias: ((token_id, bias), ...) added to the raw
    # logits; rides the decode step as the slot's row of the bias plane
    bias: tuple = ()
    # per-request sampling seed (None = the shared generator): the i-th
    # token is draw i of the seed's counter noise
    seed: "int | None" = None
    t_submit: float = 0.0
    t_first_tok: float = 0.0
    # rows already prefilled once: a manual prefix or an automatic
    # prefix-cache hit; ``cached_tokens`` is the prefill work it skips
    # (effective_prefix_reuse), answered as the body's cached_tokens
    prefix: "PrefixState | PagedPrefixState | None" = None
    cached_tokens: int = 0
    # the prefix-cache match runs once (``matched``) even if pool pressure
    # defers the admission; ``match_depth`` carries the matched length to
    # the slot assignment, where the hit or miss is recorded. A paged hit
    # pins the entry's pages (one pool reference each, ``pinned_pages``)
    # so that an eviction while the request waits cannot free rows it is
    # about to alias
    matched: bool = False
    match_depth: "int | None" = None
    pinned_pages: "list[int] | None" = None
    # paged admission: pages reserved and not yet installed in a table
    # row; ``defer_counted`` counts one pool-pressure spell once
    new_pages: "list[int] | None" = None
    defer_counted: bool = False


@dataclass
class _Inflight:
    """A dispatched, not yet read decode step: its results on their way
    to the host (``event`` marks their arrival on a card; None on the
    CPU, where they are there already) and the slots it counted live."""

    step_no: int
    arrs: tuple  # the step's results: (emitted, logps) for decode_step
    event: "torch.cuda.Event | None"
    slots: tuple[int, ...]


class ContinuousBatcher:
    """Host-side orchestrator: request queue -> slots -> token streams.

    Usage::

        cb = ContinuousBatcher(params, cfg, n_slots=4, max_len=256)
        rid = cb.submit([1, 5, 7], max_new=32)
        results = cb.run()          # {rid: [tok, ...], ...}

    Each :meth:`step` admits what fits (FIFO), prefills (a whole bucketed
    prompt at admission with ``chunked_prefill=0``, else the oldest
    mid-prefill request by one chunk), then runs one decode step for the
    whole batch and retires requests on EOS, a stop sequence or their
    ``max_new`` budget. With ``pipeline_depth=1`` the decode step is
    dispatched before the previous one is read back.

    ``kv_layout='paged'`` (or a config that says so) serves from a pool
    of ``kv_pages`` pages of ``kv_page_size`` rows, the trap page
    included; ``kv_pages=0`` sizes it to what the dense layout reserves
    plus the trap page, so the layout alone never admits less. A request
    reserves ``ceil((prompt + max_new) / kv_page_size)`` pages at
    admission; when the free list is short it waits at the head of the
    queue until a retirement frees pages. Under a sliding window
    (``cfg.sliding_window > 0``) with chunked prefill a request reserves
    only its first ``prefill_reserve_chunks`` chunks, each chunk grows the
    row, and pages below every future query's window go back to the pool,
    so a row's footprint is O(window + chunk) and not O(prompt).

    ``prefix_cache`` (a ``serving.prefix_cache.PrefixCache``, chunked
    prefill only) matches every prompt at admission and promotes every
    completed prefill at the ``prompt_buckets`` boundaries: a dense hit
    copies the prefix's rows into the slot, a paged hit aliases its pages
    in the slot's table (and copies the one partial tail page, if any).

    On a CUDA device the decode step is captured once as a CUDA graph
    (:class:`DecodeGraph`) at construction; ``decode_graph=False`` runs
    it eagerly instead (a measurement's yardstick). On the CPU it runs
    eagerly and ``decode_graph=True`` raises."""

    #: requests may carry their own Sampler (the speculative batcher turns
    #: this off: its draft and verify distributions come from one sampler)
    per_request_sampler = True
    #: per-request logit_bias planes (the speculative round threads none)
    per_request_bias = True
    #: per-request sampling seeds (the same)
    per_request_seed = True

    def __init__(
        self,
        params: dict,
        cfg: LlamaConfig,
        n_slots: int,
        max_len: int,
        sampler: "Sampler | None" = None,
        eos_id: "int | None" = None,
        prompt_buckets: tuple[int, ...] = DEFAULT_PROMPT_BUCKETS,
        chunked_prefill: int = 0,
        seed: int = 0,
        pipeline_depth: int = 1,
        kv_layout: "str | None" = None,     # None = take cfg.kv_layout
        kv_page_size: "int | None" = None,  # None = take cfg.kv_page_size
        kv_pages: int = 0,  # paged pool size; 0 = dense-equivalent + trap
        decode_graph: "bool | None" = None,  # None = on a CUDA device
        prefix_cache=None,  # serving.prefix_cache.PrefixCache (or None)
        prefill_reserve_chunks: int = 2,  # windowed admission: chunks of
        #   prompt the first page tranche covers
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
        elif kv_pages:
            raise ValueError(
                f"kv_pages={kv_pages} has no effect under kv_layout="
                "'dense' (the dense cache reserves n_slots * max_len rows)"
            )
        if chunked_prefill < 0:
            raise ValueError(
                f"chunked_prefill must be >= 0 (0 = bucketed prefill), "
                f"got {chunked_prefill}")
        if chunked_prefill > max_len:
            raise ValueError(
                f"chunked_prefill={chunked_prefill} exceeds max_len={max_len}"
            )
        if pipeline_depth not in (0, 1):
            raise ValueError(
                f"pipeline_depth must be 0 or 1, got {pipeline_depth}")
        self.device = params["embed"].device
        # the weights' quantization and resident bytes (codes and scales
        # included), for /v1/health beside the KV residency
        self.weight_stats = {"quant": weight_quant_of(params),
                             "resident_bytes": resident_bytes(params)}
        # the master-weight cast once, here: a step (and a captured one)
        # then reads the compute-dtype leaves as they are
        self.params = cast_params_for_compute(params, cfg)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.sampler = sampler or Sampler()
        self.eos_id = -1 if eos_id is None else int(eos_id)
        self.chunk = int(chunked_prefill)
        self.buckets = tuple(b for b in prompt_buckets if b <= max_len)
        if not self.chunk and not self.buckets:
            raise ValueError(
                f"no prompt bucket fits max_len={max_len} "
                f"(buckets={prompt_buckets})"
            )
        self.pipeline_depth = int(pipeline_depth)
        self.attn_plan = attention_backend_plan(
            device=self.device, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            kv_layout=cfg.kv_layout, page_size=cfg.kv_page_size,
            cache_quant=cfg.cache_quant,
            chunk=self.chunk or self.buckets[-1],
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
        if prefix_cache is not None:
            self._attach_prefix_cache(prefix_cache, cfg, max_len,
                                      prompt_buckets)
        self.prefix_cache = prefix_cache
        # paged KV: the host-side page pool (free list + refcounts)
        self.pool: "PagePool | None" = None
        self._slot_pages: dict[int, list[int]] = {}  # slot -> its page ids
        n_pages = 0
        if paged:
            per_slot = max_len // cfg.kv_page_size
            n_pages = int(kv_pages) if kv_pages > 0 else n_slots * per_slot + 1
            self.pool = PagePool(n_pages, cfg.kv_page_size)
        # sliding-window serving: a windowed row's live cache is its
        # trailing window, so on the paged layout admission reserves only
        # the first chunks, each chunk grows the row, and pages no future
        # query can attend go back to the pool (their table entries are
        # reset to the trap page, which the kernel's floor tile may read
        # under its mask)
        self.window = int(cfg.sliding_window or 0)
        self.reserve_chunks = max(1, int(prefill_reserve_chunks))
        self._incremental_reserve = (
            self.pool is not None and self.window > 0 and self.chunk > 0)
        self._pages_recycled = 0
        self.chunks_deferred = 0  # prefill chunks that waited for pages
        self._recycle_lo: dict[int, int] = {}  # slot -> first live page
        # prefill work by provenance: ``computed`` tokens ran through the
        # model, ``prefix_reused`` ones came from a prefix's rows; and
        # the pages paged prefix hits aliased instead of prefilling
        self.prefill_tokens = {"computed": 0, "prefix_reused": 0}
        self.pages_aliased = 0
        # refused or deferred paged admissions by reason; ``validate``
        # counts from request threads, hence the lock
        self._kv_rejections = {"pool_pressure": 0, "request_too_large": 0}
        self._kv_rejections_lock = threading.Lock()
        self.state = init_batch_state(cfg, n_slots, max_len, self.device,
                                      n_pages=n_pages)
        # unseeded draws of every slot come from this one generator
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # the decode step's other per-slot inputs: persistent tensors,
        # rewritten in place when the running set changes (admit, retire,
        # cancel), never per step
        dev = self.device
        self._allowed = torch.zeros((n_slots,), dtype=torch.bool, device=dev)
        self._knobs = torch.zeros((n_slots, 4), dtype=torch.float32,
                                  device=dev)
        self._bias = torch.zeros((n_slots, cfg.vocab_size),
                                 dtype=torch.float32, device=dev)
        self._eos = torch.tensor(self.eos_id, dtype=torch.int64, device=dev)
        self._slots_dirty = True
        self.pending: list[_Request] = []
        self.running: dict[int, _Request] = {}     # slot -> decoding request
        self.prefilling: dict[int, _Request] = {}  # slot -> mid-prefill
        self._prefill_pos: dict[int, int] = {}     # slot -> next chunk start
        self.done: dict[int, list[int]] = {}
        self.done_requests: dict[int, _Request] = {}
        self._next_rid = 0
        # the (at most one) dispatched-but-unread decode step
        self._inflight: "_Inflight | None" = None
        self._step_no = 0
        self.pipeline_flushes = 0
        # work counters. decode_s is host wall over the decode part of
        # each step (the dispatch and the readback, waits included), so
        # its mean per dispatched step is the steady step's wall time;
        # prefill_s is host wall around each prefill dispatch up to its
        # own completion (a wait for an in-flight decode ahead of it is
        # charged to decode_s)
        self.decode_steps = 0
        self.decode_tokens = 0
        self.decode_s = 0.0
        self.prefill_chunks = 0  # prefill dispatches: chunks or buckets
        self.prefill_s = 0.0
        on_cuda = dev.type == "cuda"
        if decode_graph and not on_cuda:
            raise ValueError(
                f"decode_graph=True needs a CUDA device, not {dev}: the "
                "CPU runs the eager decode step")
        # pinned landing buffers for the readback (made at the first
        # dispatch, shaped like the step's results), two so that step
        # t+1's copy never lands on step t's before the host read it
        self._landing: "list[tuple] | None" = None
        self._refresh_slot_inputs()  # every slot out, the default knobs
        self.graph: "DecodeGraph | None" = None
        self._graph_wanted = on_cuda and decode_graph is not False
        if self._graph_wanted:
            self._capture_graph()

    def _capture_graph(self) -> None:
        """Capture :meth:`_eager_step` as the decode graph. Called while
        no slot is allowed: the warm-up steps compute and discard,
        writing only the trap rows."""
        self.graph = DecodeGraph(self._eager_step, self.generator,
                                 self.device)

    def _attach_prefix_cache(self, pc, cfg: LlamaConfig, max_len: int,
                             prompt_buckets: tuple[int, ...]) -> None:
        """Bind an automatic prefix cache to this batcher's chunk, bucket
        ladder and layout: its match gate, savings and promotion
        boundaries depend on them. A cache holding entries promoted on
        another ladder, or paged entries (their page ids belong to the
        pool of the batcher that promoted them), or entries of the other
        layout, is refused."""
        if not self.chunk:
            raise ValueError(
                "automatic prefix caching requires chunked_prefill=C (the "
                "chunk scheduler continues a prefill from the matched "
                "boundary)")
        if not self.buckets:
            raise ValueError(
                f"automatic prefix caching needs a prompt bucket <= "
                f"max_len={max_len} (buckets={prompt_buckets}): promotion "
                "boundaries are the bucket ladder")
        if pc.stats.nodes and tuple(pc.buckets) != self.buckets:
            raise ValueError(
                "prefix cache already holds entries promoted on a "
                f"different bucket ladder {pc.buckets} (this batcher's: "
                f"{self.buckets})")
        held = getattr(pc.cfg, "kv_layout", "dense")
        if pc.stats.entries and held == "paged":
            raise ValueError(
                "prefix cache already holds paged entries: their page ids "
                "belong to the pool of the batcher that promoted them; "
                "attach a fresh PrefixCache")
        if pc.stats.entries and held != cfg.kv_layout:
            raise ValueError(
                "prefix cache already holds entries materialized under "
                f"kv_layout={held!r} (this batcher's: {cfg.kv_layout!r})")
        pc.chunk = self.chunk
        pc.buckets = self.buckets
        # paged entries round their residency up to whole pages
        pc.cfg = cfg
        if cfg.kv_layout == "paged":
            # entries hold page references, given back at eviction; the
            # presence row moves to the batcher's device once, here
            device = self.device
            pc.entry_factory = (
                lambda rows, tokens, presence, adapter: PagedPrefixState(
                    page_ids=tuple(rows), tokens=tokens,
                    presence=presence.to(device), adapter=adapter))
            pc.release_entry = _paged_release_hook(self)
        else:
            pc.entry_factory = PrefixState
            pc.release_entry = None

    # --- admission rule ---

    def validate(self, prompt_len: int, max_new: int) -> None:
        """Raise ValueError iff ``submit`` of a prompt this long would."""
        if prompt_len < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if self._kv_need_tokens(prompt_len, max_new) > self.max_len:
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
            tokens = self._kv_need_tokens(prompt_len, max_new)
            if self._incremental_reserve:
                # a windowed row never holds its whole prompt: its peak
                # is the trailing window plus the chunks in flight (or
                # the decode span), so the wall moves from O(prompt) to
                # O(window + chunk)
                tokens = min(tokens, self._windowed_peak_tokens(max_new))
            need = self.pool.pages_for_tokens(tokens)
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
        if not self.chunk:
            _bucket(prompt_len, self.buckets)

    def validate_prompt(self, prompt) -> list[int]:
        toks = [int(t) for t in prompt]
        bad = [t for t in toks if not 0 <= t < self.cfg.vocab_size]
        if bad:
            raise ValueError(
                f"prompt token {bad[0]} outside vocab [0, "
                f"{self.cfg.vocab_size})"
            )
        return toks

    def validate_bias(self, logit_bias) -> tuple:
        """A logit_bias mapping ({token_id: bias} or pairs) -> a tuple of
        (token, bias) pairs. OpenAI's bounds: at most 300 entries, each
        bias in [-100, 100], token ids in the vocabulary."""
        if not logit_bias:
            return ()
        items = (logit_bias.items() if isinstance(logit_bias, dict)
                 else list(logit_bias))
        out = []
        for tok, b in items:
            tok, b = int(tok), float(b)
            if not 0 <= tok < self.cfg.vocab_size:
                raise ValueError(
                    f"logit_bias token {tok} outside vocab "
                    f"[0, {self.cfg.vocab_size})"
                )
            if not -100.0 <= b <= 100.0:
                raise ValueError(f"logit_bias value {b} outside [-100, 100]")
            out.append((tok, b))
        if len(out) > 300:
            raise ValueError(
                f"logit_bias supports at most 300 entries (got {len(out)})"
            )
        return tuple(out)

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
        logit_bias=None,
        prefix: "PrefixState | None" = None,
        **unserved,
    ) -> int:
        """Queue a request; returns its id. ``prefix``
        (:func:`precompute_prefix`) prepends a shared prefilled prefix:
        its rows are copied into the slot at admission and only
        ``prompt`` (the suffix) runs through prefill (chunked prefill
        only). With a ``prefix_cache`` attached, a request naming no
        prefix is matched against the cache at admission instead."""
        _refuse("submit", unserved, _UNSERVED_SUBMIT)
        if prefix is not None:
            if not self.chunk:
                raise ValueError("prefix sharing requires chunked_prefill=C")
            if isinstance(prefix, PagedPrefixState):
                # its page references belong to the attached cache, which
                # pins them at match time; a manual one would reach
                # admission unpinned
                raise ValueError(
                    "PagedPrefixState cannot be submitted manually: paged "
                    "prefix entries are owned by the attached prefix cache "
                    "(manual prefixes carry dense rows from "
                    "precompute_prefix)")
            if prefix.adapter != -1:
                raise ValueError(
                    f"prefix was prefilled with adapter {prefix.adapter}, "
                    "request uses -1")
        prompt = self.validate_prompt(prompt)
        full = (list(prefix.tokens) if prefix is not None else []) + prompt
        self.validate(len(full), max_new)
        bias = self.validate_bias(logit_bias)
        seed = self.validate_seed(seed)
        rid = self._next_rid
        self._next_rid += 1
        self.pending.append(_Request(
            rid, full, int(max_new),
            stop=tuple(tuple(int(t) for t in s) for s in (stop or ()) if s),
            sampler=sampler, bias=bias, seed=seed,
            t_submit=time.perf_counter(), prefix=prefix,
            # a manual prefix reports its effective reuse too (automatic
            # hits are set at admission)
            cached_tokens=(effective_prefix_reuse(
                len(prefix.tokens), len(full), self.chunk)
                if prefix is not None else 0),
        ))
        return rid

    # --- the decode step's per-slot inputs ---

    def _h2d(self, values, dtype: torch.dtype) -> torch.Tensor:
        """Host values -> a tensor on the batcher's device, copied from
        pinned memory without a stream sync on a card (the copy queues
        behind an in-flight step instead of waiting for it)."""
        host = torch.tensor(values, dtype=dtype,
                            pin_memory=self.device.type == "cuda")
        return host.to(self.device, non_blocking=True)

    def _req_knobs(self, req: _Request) -> torch.Tensor:
        return self._h2d(sampler_knobs(req.sampler or self.sampler),
                         torch.float32)

    def _refresh_slot_inputs(self) -> None:
        """Rewrite the membership mask and the knobs for the current
        running set, in place: once per admit/retire/cancel, never in
        the steady loop."""
        if not self._slots_dirty:
            return
        rows = [sampler_knobs(self.sampler)] * self.n_slots
        for slot, req in self.running.items():
            if req.sampler is not None:
                rows[slot] = sampler_knobs(req.sampler)
        self._knobs.copy_(self._h2d(rows, torch.float32))
        self._allowed.copy_(self._h2d(
            [s in self.running for s in range(self.n_slots)], torch.bool))
        self._slots_dirty = False

    def _open_slot(self, req: _Request, slot: int) -> None:
        """Admission writes the slot's seed and its row of the bias plane
        (zero already, unless the request brings a bias)."""
        self.state.seeds[slot] = -1 if req.seed is None else req.seed
        if req.bias:
            toks, vals = zip(*req.bias)
            self._bias[slot].index_put_(
                (self._h2d(list(toks), torch.int64),),
                self._h2d(list(vals), torch.float32), accumulate=True)

    def _close_slot(self, req: _Request, slot: int) -> None:
        """Retirement or cancellation: the slot leaves the decode's
        membership, its bias row goes back to zeros, its pages to the
        pool."""
        self._slots_dirty = True
        if req.bias:
            self._bias[slot].zero_()
        self._release_slot_pages(slot)

    # --- paged-KV admission (no-ops on the dense layout) ---

    def _kv_need_tokens(self, prompt_len: int, max_new: int) -> int:
        """Worst-case cache rows one admission must cover: the one place
        every reservation asks (``validate``'s slot and pool walls,
        ``_reserve_pages``, the windowed tranches), so that a refusal at
        submit and a deferral at admission cannot disagree."""
        return prompt_len + max_new

    def _windowed_peak_tokens(self, max_new: int) -> int:
        """Upper bound on the rows one windowed row has live at once
        under incremental reservation: the trailing window, the admission
        tranche plus one chunk in flight (recycling lags the cursor by the
        finish chunk's back-scheduled overlap), the larger of one chunk
        and the decode span (grown at the finish chunk, recycled during
        decode), and two pages of boundary rounding. ``validate`` admits
        against it, so a deferred growth can always succeed later."""
        return (self.window + (self.reserve_chunks + 1) * self.chunk
                + max(self.chunk, max_new) + 2 * self.pool.page_size)

    def _initial_reserve_tokens(self, req: _Request) -> int:
        """A windowed request's admission tranche: rows through the first
        ``reserve_chunks`` chunks past the prefix match (growth backs the
        rest chunk by chunk). A short request is covered whole."""
        total = self._kv_need_tokens(len(req.prompt), req.max_new)
        start = len(req.prefix.tokens) if req.prefix is not None else 0
        return min(total, start + self.reserve_chunks * self.chunk)

    def _outstanding_growth_pages(self) -> int:
        """Pages the windowed prefills in flight may still draw before
        they peak: headroom a new admission must not eat. Two long
        prompts admitted into one window's worth of free pages would
        starve each other (only the oldest prefill advances), so keeping
        the in-flight peaks admissible makes a growth deferral
        transient."""
        if not self._incremental_reserve:
            return 0
        out = 0
        for slot, req in self.prefilling.items():
            peak = self.pool.pages_for_tokens(min(
                self._kv_need_tokens(len(req.prompt), req.max_new),
                self._windowed_peak_tokens(req.max_new)))
            backed = sum(1 for p in (self._slot_pages.get(slot) or []) if p)
            out += max(0, peak - backed)
        return out

    def _reserve_pages(self, req: _Request) -> bool:
        """Pool-pressure check and reservation for one admission. The
        pages a paged prefix hit aliases are pinned already (match time),
        so only the copy-on-write tail and the fresh pages draw on the
        free list. False defers: the request keeps the head of the queue
        and pages free as slots retire. One spell of waiting counts
        once."""
        ps = self.pool.page_size
        total = self.pool.pages_for_tokens(
            self._kv_need_tokens(len(req.prompt), req.max_new))
        if self._incremental_reserve:
            # windowed streaming prefill: only the admission tranche; the
            # chunks grow the rest and recycling keeps the row O(window)
            total = min(total, self.pool.pages_for_tokens(
                self._initial_reserve_tokens(req)))
        # headroom for the windowed growth in flight: counted against the
        # free list below, never allocated here
        growth = self._outstanding_growth_pages()
        aliased = 0
        if isinstance(req.prefix, PagedPrefixState):
            # full shared pages alias; a partial tail page still needs a
            # fresh page (the copy's destination)
            aliased = len(req.prefix.tokens) // ps
        need = total - aliased
        if need + growth > self.pool.free_pages and \
                self.prefix_cache is not None:
            # pool pressure: promoted prefixes are reclaimable capacity.
            # Evict LRU entries until the reservation fits, but only when
            # reclaiming everything could close the gap: pages that slots
            # or queued requests' pins hold stay allocated however much
            # of the cache goes
            held = set()
            for ids in self._slot_pages.values():
                held.update(ids)
            for r in self.pending:
                if r.pinned_pages:
                    held.update(r.pinned_pages)
            reclaimable = self.pool.in_use - len(held)
            if self.pool.free_pages + reclaimable >= need + growth:
                while (need + growth > self.pool.free_pages
                       and self.prefix_cache.evict_one()):
                    pass
        if (need > self.pool.free_pages and not self.running
                and not self.prefilling):
            # the futile-deferral escape: nothing runs, so no retirement
            # will ever free a page, and what the valve could not reclaim
            # this request pins itself (a matched prefix whose partial
            # tail page it pins for the copy). Admit it cold instead: drop
            # the hit, release the pins, reclaim; ``validate`` guaranteed
            # the cold reservation fits the pool
            self._release_pinned(req)
            if isinstance(req.prefix, PagedPrefixState):
                req.prefix = None
                req.match_depth = None
                req.cached_tokens = 0
                need = total
            if self.prefix_cache is not None:
                while (need > self.pool.free_pages
                       and self.prefix_cache.evict_one()):
                    pass
        if need + growth > self.pool.free_pages:
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
        """Upload the slot's page-table row (aliased, copied-on-write and
        fresh pages, then zeros: the trap page) and make the paged
        prefix insert: an automatic hit is table aliasing plus at most one
        copy of the partial tail page; a manual (dense-row) prefix is
        scattered into the fresh pages. The one upload a fully reserved
        request's table costs."""
        if slot in self._slot_pages:
            raise RuntimeError(f"slot {slot} still holds pages")
        ps = self.pool.page_size
        new, req.new_pages = req.new_pages or [], None
        shared: list[int] = []
        cow = None
        hit = isinstance(req.prefix, PagedPrefixState)
        if hit:
            m = len(req.prefix.tokens)
            pinned, req.pinned_pages = req.pinned_pages, None
            if pinned is None:
                raise RuntimeError("paged prefix reached install unpinned")
            # the match-time pins of the full pages move to the slot
            shared = pinned[:m // ps]
            if m % ps:
                cow = (pinned[m // ps], new[0])
        ids = shared + new
        self._slot_pages[slot] = ids
        row = self._h2d(ids + [0] * (self.state.pages.shape[1] - len(ids)),
                        torch.int32)
        if hit:
            _alias_slot_pages(self.state, row, req.prefix.presence, slot)
            self.pages_aliased += len(shared)
            if cow is not None:
                src, dst = cow
                _copy_page(self.state, src, dst)
                _KV_COPIES["cow_pages"] += 1
                # the tail pin served only the copy's read: the slot owns
                # its private copy now
                self.pool.decref([src])
            return
        self.state.pages[slot] = row
        if req.prefix is not None:
            # a manual prefix into a paged slot: a real row copy
            _insert_prefix(self.state, req.prefix.rows, req.prefix.presence,
                           slot, self.cfg)
            _KV_COPIES["rows"] += len(req.prefix.tokens)

    # --- incremental reservation and out-of-window recycling ---

    def _grow_slot_pages(self, slot: int, req: _Request,
                         upto_tokens: int) -> bool:
        """Back positions ``[0, upto_tokens)`` of ``slot`` with real
        pages: the growth half of incremental reservation, one row upload
        per chunk that grows (recycled entries stay 0, the trap page).
        False on pool pressure, with nothing allocated: the caller defers
        the chunk, and the request keeps its slot, its cursor and every
        page grown so far."""
        ids = self._slot_pages[slot]
        grow = self.pool.pages_for_tokens(upto_tokens) - len(ids)
        if grow <= 0:
            return True
        if grow > self.pool.free_pages and self.prefix_cache is not None:
            # the admission's pressure valve, mid-prompt
            while grow > self.pool.free_pages and self.prefix_cache.evict_one():
                pass
        if grow > self.pool.free_pages:
            self.chunks_deferred += 1
            get_logger().debug(
                "prefill chunk deferred: KV pool pressure (rid %d needs %d "
                "pages, %d free)", req.rid, grow, self.pool.free_pages)
            return False
        ids += self.pool.alloc(grow)
        self.state.pages[slot] = self._h2d(
            ids + [0] * (self.state.pages.shape[1] - len(ids)), torch.int32)
        return True

    def _recycle_slot_pages(self, slot: int, pos: int) -> None:
        """Free the pages no future query of this row can attend: queries
        at positions >= ``pos`` reach keys in ``(q - window, q]``, so a
        page whose last position is <= ``pos - window`` is dead. The
        pages go back to the pool (a page a prefix entry shares only
        drops this row's reference), and their table entries are reset
        to the trap page on the device: the kernel starts a span at the
        64-row tile that holds the window floor, so with pages smaller
        than a tile it reads up to three dead entries under its mask, and
        a recycled page may since hold another slot's rows. The reset is
        queued behind the step in flight, which still reads the old
        entries: their pages are written only by work queued after it."""
        if not self._incremental_reserve:
            return
        ids = self._slot_pages.get(slot)
        if not ids:
            return
        ps = self.pool.page_size
        # page k spans [k*ps, (k+1)*ps); dead iff (k+1)*ps <= pos-W+1
        dead = min(max(0, (pos - self.window + 1) // ps), len(ids))
        lo = self._recycle_lo.get(slot, 0)
        if dead <= lo:
            return
        batch = [p for p in ids[lo:dead] if p]
        ids[lo:dead] = [0] * (dead - lo)
        self._recycle_lo[slot] = dead
        self.state.pages[slot, lo:dead] = 0
        if batch:
            self._pages_recycled += self.pool.recycle(batch)

    def _release_slot_pages(self, slot: int) -> None:
        """Drop the slot's page references when its request retires or
        is cancelled: pages shared with the prefix cache (or other
        slots) stay until their last holder lets go, recycled entries (0)
        were freed already. The table row stays as it is: the decode step
        masks an inactive slot's row to the trap page, and the next
        admission overwrites it."""
        if self.pool is None:
            return
        self._recycle_lo.pop(slot, None)
        ids = self._slot_pages.pop(slot, None)
        if ids:
            self.pool.decref([p for p in ids if p])

    def _release_pinned(self, req: _Request) -> None:
        """Give back the match-time page pins of a request that will not
        alias them (cancelled while it waited, or admitted cold)."""
        if self.pool is not None and req.pinned_pages:
            self.pool.decref(req.pinned_pages)
            req.pinned_pages = None

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
        capacity not covered by live tokens: tail-page waste and pages
        that promoted prefixes pin), the pages recycled out of windows and
        the pages prefix hits aliased. A snapshot: the HTTP thread reads it
        while the engine thread admits and retires."""
        tb = kv_token_bytes(self.cfg)
        # attn_window only when windowed: at window 0 the dict is the
        # window-less one, as the reference keeps it
        windowed = {"attn_window": self.window} if self.window else {}
        if self.pool is None:
            return {"layout": "dense", **windowed,
                    "reserved_bytes": self.n_slots * self.max_len * tb}
        live = sum(len(r.prompt) + len(r.out)
                   for r in list(self.running.values()))
        live += sum(self._prefill_pos.get(s, 0) for s in list(self.prefilling))
        pool = self.pool
        cap_tokens = pool.in_use * pool.page_size
        return {
            "layout": "paged",
            **windowed,
            "page_size": pool.page_size,
            "pages_total": pool.capacity,
            "pages_in_use": pool.in_use,
            "pages_free": pool.free_pages,
            "pages_in_use_peak": pool.peak_in_use,
            "pages_recycled_total": self._pages_recycled,
            "pages_aliased": self.pages_aliased,
            "fragmentation_pct": (
                100.0 * (1.0 - min(live, cap_tokens) / cap_tokens)
                if cap_tokens else 0.0
            ),
            "reserved_bytes": pool.n_pages * pool.page_size * tb,
            "in_use_bytes": cap_tokens * tb,
        }

    def decode_stats(self) -> dict:
        """How the decode step runs, for ``/v1/health``: the pipeline
        depth, flushes of the in-flight step, and the captured graph
        (its private pool's bytes, replays, launches a replay makes), or
        None where the step runs eagerly."""
        return {"pipeline_depth": self.pipeline_depth,
                "pipeline_flushes": self.pipeline_flushes,
                "graph": None if self.graph is None else self.graph.stats()}

    # --- admission and prefill ---

    def _admit(self) -> None:
        free = [s for s in range(self.n_slots)
                if s not in self.running and s not in self.prefilling]
        while free and self.pending:
            req = self.pending[0]
            if (self.prefix_cache is not None and req.prefix is None
                    and len(req.prompt) > 1 and not req.matched):
                # the automatic match site: past validation, and late
                # enough to see every prefix promoted since the request
                # queued. Uncounted here: a deferred request may still be
                # cancelled; the disposition is recorded at the slot
                # assignment below. It runs before the page reservation:
                # the hit decides how many pages alias and how many are
                # allocated
                req.matched = True
                hit = self.prefix_cache.match(req.prompt, -1, count=False)
                if hit is not None:
                    req.prefix, req.match_depth = hit
                    req.cached_tokens = self.prefix_cache.effective_reuse(
                        req.match_depth, len(req.prompt))
                    if isinstance(req.prefix, PagedPrefixState):
                        # pin the entry's pages now: an eviction while
                        # this request waits must not free rows it is
                        # about to alias
                        pin = list(req.prefix.page_ids)
                        self.pool.incref(pin)
                        req.pinned_pages = pin
            if self.pool is not None and not self._reserve_pages(req):
                break  # head-of-line wait: pages free as slots retire
            self.pending.pop(0)
            req.slot = slot = free.pop(0)
            if req.matched:
                self.prefix_cache.record_match(req.match_depth,
                                               len(req.prompt))
            if self.pool is not None:
                self._install_pages(req, slot)
            self._open_slot(req, slot)
            if self.chunk:
                start = 0
                if req.prefix is not None:
                    if self.pool is None:
                        # copy the shared rows and presence; the paged
                        # layout aliased them in _install_pages
                        _insert_prefix(self.state, req.prefix.rows,
                                       req.prefix.presence, slot, self.cfg)
                        _KV_COPIES["rows"] += len(req.prefix.tokens)
                    start = len(req.prefix.tokens)
                    self._count_prefill_tokens(req.cached_tokens,
                                               "prefix_reused")
                self.prefilling[slot] = req
                self._prefill_pos[slot] = start
                self._on_prefill_scheduled(req, slot, start)
                continue
            plen = len(req.prompt)
            bucket = _bucket(plen, self.buckets)
            padded = self._h2d(req.prompt + [0] * (bucket - plen),
                               torch.int64)
            t0 = time.perf_counter()
            tok, logp = prefill_insert(
                self.params, self.state, padded, plen, slot, self.cfg,
                self._req_knobs(req), req.max_new, self.generator,
                bias=self._bias[slot:slot + 1],
                seeds=self.state.seeds[slot:slot + 1],
            )
            self._count_prefill_tokens(plen, "computed")
            self._first_token(req, slot, tok, logp, t0)
            self._finish_if_done(req)

    def _count_prefill_tokens(self, n: int, source: str) -> None:
        """Prefill work by provenance: ``computed`` tokens ran through
        the model (the finish chunk's overlap included: it is real
        compute), ``prefix_reused`` ones came from a prefix's rows."""
        if n > 0:
            self.prefill_tokens[source] += n

    def _wait_prefill(self, done: "torch.cuda.Event | None",
                      t0: float) -> None:
        """Charge a prefill dispatch its own time: a decode step still in
        flight ahead of it is waited for first and charged to decode_s,
        then the prefill's own completion event."""
        t1 = time.perf_counter()
        if self._inflight is not None and self._inflight.event is not None:
            self._inflight.event.synchronize()
            t2 = time.perf_counter()
            self.decode_s += t2 - t1
        else:
            t2 = t1
        if done is not None:
            done.synchronize()
        self.prefill_chunks += 1
        self.prefill_s += (t1 - t0) + (time.perf_counter() - t2)

    def _done_event(self) -> "torch.cuda.Event | None":
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _first_token(self, req: _Request, slot: int, tok: torch.Tensor,
                     logp: torch.Tensor, t0: float) -> None:
        """A prefill's first token reaches the host: the request moves
        to running (the caller then retires it if that token ends it)."""
        self._wait_prefill(self._done_event(), t0)
        req.out.append(int(tok[0]))
        req.out_logp.append(float(logp[0]))
        req.t_first_tok = time.perf_counter()
        self.running[slot] = req
        self._slots_dirty = True

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
        if self.pool is not None:
            # incremental reservation (windowed rows): back the pages this
            # chunk writes, and the decode span on the finish chunk,
            # before the dispatch. Pool pressure defers the chunk, never
            # the request. A fully reserved row is backed already
            upto = start + c if start + c < plen else plen + req.max_new
            if not self._grow_slot_pages(slot, req, upto):
                return
        t0 = time.perf_counter()
        if start + c < plen:  # intermediate chunk, all real tokens
            chunk = self._h2d(req.prompt[start:start + c], torch.int64)
            self._apply_prefill_chunk(chunk, start, slot)
            # nothing reads this chunk back: wait for it here, or its
            # device time would be charged to the next decode step
            self._wait_prefill(self._done_event(), t0)
            self._prefill_pos[slot] = start + c
            # recycle behind the cursor, floored at the finish chunk's
            # back-scheduled start: its overlap rewrites those rows and
            # its queries attend them
            self._recycle_slot_pages(slot, min(start + c, max(plen - c, 0)))
            self._count_prefill_tokens(c, "computed")
            return
        fstart = max(0, plen - c)
        rest = req.prompt[fstart:]
        chunk = self._h2d(rest + [0] * (c - len(rest)), torch.int64)
        tok, logp = self._apply_prefill_finish(chunk, fstart, plen, slot)
        del self.prefilling[slot], self._prefill_pos[slot]
        self._count_prefill_tokens(plen - fstart, "computed")
        self._first_token(req, slot, tok, logp, t0)
        # decode queries start at plen: everything below plen - window is
        # dead now (promotion then sees the recycled row and skips it)
        self._recycle_slot_pages(slot, plen)
        self._maybe_promote_prefix(req)
        self._finish_if_done(req)

    # overridable seams (the speculative batcher mirrors them onto a
    # second, draft-model state)

    def _on_prefill_scheduled(self, req: _Request, slot: int,
                              start: int) -> None:
        """A chunked prefill was just scheduled for ``slot``, continuing
        from ``start`` (> 0 iff a prefix served rows [0, start)). Nothing
        to do here; the speculative batcher queues its draft backfill."""

    def _apply_prefill_chunk(self, chunk: torch.Tensor, start: int,
                             slot: int) -> None:
        """One intermediate chunk of ``slot``'s prompt at ``start``."""
        prefill_chunk(self.params, self.state, chunk, start, slot, self.cfg)

    def _apply_prefill_finish(self, chunk: torch.Tensor, fstart: int,
                              plen: int, slot: int,
                              ) -> tuple[torch.Tensor, torch.Tensor]:
        """The finish chunk of ``slot``'s prompt: samples the first token
        with the slot's knobs, bias row and seed. Returns (token, logprob)
        on the device."""
        req = self.prefilling[slot]
        return prefill_finish(
            self.params, self.state, chunk, fstart, plen, slot, self.cfg,
            self._req_knobs(req), req.max_new, self.generator,
            bias=self._bias[slot:slot + 1],
            seeds=self.state.seeds[slot:slot + 1],
        )

    def _maybe_promote_prefix(self, req: _Request) -> None:
        """Offer a completed chunked prefill's prompt to the prefix
        cache, which decides which boundaries to materialize. The slot
        holds the whole prompt's K/V at this moment, however much of it
        came from a matched prefix: paged entries take a reference on
        each page a boundary spans (no device work), dense entries copy
        the boundary's rows (:func:`extract_prefix_rows`)."""
        if self.prefix_cache is None:
            return
        if self.pool is not None:
            slot_pages = self._slot_pages[req.slot]
            if any(p == 0 for p in slot_pages):
                # windowed prefill recycled pages: the prompt's early
                # rows are gone, so no boundary is materializable
                return

            def extract(p: int) -> tuple:
                # nothing between the incref and the return: the cache
                # owns these references from here
                ids = tuple(slot_pages[:self.pool.pages_for_tokens(p)])
                self.pool.incref(ids)
                return ids

            self.prefix_cache.on_prefill_done(req.prompt, -1, extract)
            return
        slot = req.slot

        def extract_dense(p: int) -> KVCache:
            _KV_COPIES["rows"] += p
            return extract_prefix_rows(self.state, slot, p)

        self.prefix_cache.on_prefill_done(req.prompt, -1, extract_dense)

    def precompute_shared_prefix(self, tokens) -> "PrefixState":
        """:func:`precompute_prefix` against this batcher's params and
        bucket ladder."""
        return precompute_prefix(self.params, tokens, self.cfg,
                                 prompt_buckets=self.buckets
                                 or DEFAULT_PROMPT_BUCKETS)

    # --- the decode loop ---

    def _eager_step(self) -> tuple[torch.Tensor, torch.Tensor]:
        """:func:`decode_step` over the persistent inputs (what the graph
        captures)."""
        return decode_step(self.params, self.state, self._allowed, self._eos,
                           self.cfg, self._knobs, self.generator,
                           bias=self._bias, seeds=self.state.seeds)

    def _decode_dispatch(self) -> tuple:
        """The device half of a decode step: one replay of the captured
        graph (or one eager step) over the persistent inputs, returning
        the result tensors :meth:`_apply_decode_result` consumes. The
        speculative batcher's step is a draft-and-verify round, whose
        results carry per-slot acceptance counts too."""
        if self.graph is not None:
            return self.graph.replay()
        return self._eager_step()

    def _apply_decode_result(self, arrs: tuple) -> int:
        """The host half: the step's results (on the host already) ->
        the per-token work. Returns the tokens emitted."""
        emitted, logps = (x.tolist() for x in arrs)
        return self._apply_emitted(emitted, logps)

    def _dispatch_decode(self) -> None:
        """Enqueue one decode step without waiting for it: its results
        start for the host at once (pinned buffers, an event) and wait in
        ``_inflight`` with the slots it counted live."""
        t0 = time.perf_counter()
        self._refresh_slot_inputs()
        arrs = self._decode_dispatch()
        event = None
        if self.device.type == "cuda":
            if self._landing is None:
                self._landing = [tuple(
                    torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    for x in arrs) for _ in range(2)]
            landing = self._landing[self._step_no % 2]
            for host, dev in zip(landing, arrs):
                host.copy_(dev, non_blocking=True)
            arrs = landing
            event = torch.cuda.Event()
            event.record()
        self._inflight = _Inflight(self._step_no, arrs, event,
                                   tuple(self.running))
        self._step_no += 1
        self.decode_steps += 1
        self.decode_s += time.perf_counter() - t0

    def _read_step(self, inflight: "_Inflight | None") -> int:
        """Read a dispatched step back and run the host's per-token work
        for it; None (the pipeline's first step) reads nothing."""
        if inflight is None:
            return 0
        t0 = time.perf_counter()
        if inflight.event is not None:
            inflight.event.synchronize()
        self.decode_s += time.perf_counter() - t0
        return self._apply_decode_result(inflight.arrs)

    def _decode_once(self) -> int:
        """One synchronous decode step: dispatch, then read it back."""
        self._dispatch_decode()
        inflight, self._inflight = self._inflight, None
        return self._read_step(inflight)

    def _inflight_covers_rest(self, inflight: _Inflight) -> bool:
        """True when the in-flight step's pending tokens retire every
        running request on budget: a dispatch ahead would compute a whole
        batch of -1 sentinels. Conservative, since EOS and stop
        retirements cannot be predicted on the host."""
        return all(
            len(req.out) + (1 if slot in inflight.slots else 0) >= req.max_new
            for slot, req in self.running.items()
        )

    def _flush_inflight(self) -> int:
        """Drain the in-flight step before an admission that could reuse
        one of its live slots: its tokens are applied against the current
        running map, so a freed slot's lagging token is dropped here
        rather than given to the slot's next occupant."""
        prev, self._inflight = self._inflight, None
        if prev is None:
            return 0
        self.pipeline_flushes += 1
        return self._read_step(prev)

    def _apply_emitted(self, emitted: list, logps: list) -> int:
        """Append one read-back step's tokens and logprobs and retire what
        finished. Slots no longer running (retired or cancelled since the
        dispatch) and -1 sentinels are skipped: the lag-by-one drop that
        makes the pipeline exact."""
        n = 0
        for slot, req in list(self.running.items()):
            tok = emitted[slot]
            if tok >= 0:
                n += 1
                req.out.append(tok)
                req.out_logp.append(logps[slot])
                self._finish_if_done(req)
                # sliding-window decode: pages leave the window as the
                # row advances, so its footprint stays O(window); a slot
                # just retired is a no-op (its ledger is gone)
                self._recycle_slot_pages(
                    slot, len(req.prompt) + len(req.out) - 1)
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
            self._close_slot(req, req.slot)

    def cancel(self, rid: int) -> bool:
        """Retire ``rid`` wherever it lives (pending, mid-prefill or
        decoding), keeping the tokens it has. False for unknown or
        finished ids. A step in flight is not read here: its token for
        the slot is dropped on readback."""
        for i, req in enumerate(self.pending):
            if req.rid == rid:
                self.pending.pop(i)
                self._release_pinned(req)  # a paged hit's match-time pins
                self._retire(req)
                return True
        for mapping in (self.prefilling, self.running):
            for slot, req in list(mapping.items()):
                if req.rid == rid:
                    del mapping[slot]
                    self._prefill_pos.pop(slot, None)
                    self._close_slot(req, slot)
                    self._retire(req)
                    return True
        return False

    def step(self) -> int:
        """Admit what fits, prefill (a bucketed prompt at admission, or
        one chunk), then one decode step for the whole batch. Returns the
        tokens read back in this call.

        With ``pipeline_depth=1`` the call dispatches step t+1 and only
        then reads step t back. The flush-first rule: when this call may
        change slot occupancy (pending admissions, prefill progress, or
        an emptied batch) and a slot the in-flight step counted live has
        since been freed, the in-flight step is read first, so that its
        stale token cannot be given to the slot's next occupant. When
        every in-flight slot is still running (a saturated queue, steady
        chunked admission) nothing is flushed."""
        n = 0
        inflight = self._inflight
        if inflight is not None and (
                self.pending or self.prefilling or not self.running) and any(
                s not in self.running for s in inflight.slots):
            n += self._flush_inflight()
        self._admit()
        self._prefill_one_chunk()
        if not self.running:
            return n
        if not self.pipeline_depth:
            return n + self._decode_once()
        prev, self._inflight = self._inflight, None
        if prev is not None and self._inflight_covers_rest(prev):
            # the budgets retire every running request with the step in
            # flight: read it rather than dispatch a step of sentinels
            n += self._read_step(prev)
            if self.running:  # never on budget; EOS and stop can't
                self._dispatch_decode()
            return n
        self._dispatch_decode()
        return n + self._read_step(prev)

    def run(self, max_steps: "int | None" = None) -> dict[int, list[int]]:
        """Drive until every submitted request finished (or max_steps)."""
        steps = 0
        while self.pending or self.running or self.prefilling:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return dict(self.done)


# ---------------- shared prefixes ----------------
#
# A prefix prefilled once serves every request that starts with it: its
# rows go into the slot at admission and only the suffix is
# chunk-prefilled. ``precompute_prefix`` makes one by hand;
# serving/prefix_cache.py is the automatic tier, an index of prefixes the
# batcher promotes from completed prefills (``_maybe_promote_prefix``)
# and matches at admission (``_admit``).
#
# On the paged layout a promoted prefix is a set of page references
# (``PagedPrefixState``) and a hit aliases them into the slot's table: no
# row moves. The one copy left is the copy-on-write of a partially
# filled tail page (a boundary inside a page), which the hitting slot
# will append its suffix to. ``kv_copy_counts()`` counts both.


@dataclass(frozen=True)
class PrefixState:
    """An immutable prefilled prefix: its cache rows (a single-row
    ``KVCache`` (L, 1, P, Hkv, hd), codes and scales alike), the tokens
    (the finish chunk's overlap recomputes across the prefix boundary)
    and the presence row over them."""

    rows: KVCache
    tokens: tuple
    presence: torch.Tensor  # (V,) bool over the real tokens
    # the adapter the rows were prefilled under (-1 = base): always -1
    # here, adapters are not served
    adapter: int = -1


@dataclass(frozen=True)
class PagedPrefixState:
    """A promoted prefix on the paged layout: physical page ids, each
    holding a pool reference taken at promotion, in place of rows. The
    same ``tokens``/``presence``/``adapter`` as :class:`PrefixState`;
    ``page_ids`` spans ceil(len(tokens) / page_size) pages, the last one
    possibly partial (the copy-on-write case)."""

    page_ids: tuple
    tokens: tuple
    presence: torch.Tensor
    adapter: int = -1


_KV_COPIES = {"rows": 0, "cow_pages": 0}


def kv_copy_counts() -> dict:
    """KV data movement on the prefix paths so far: ``rows`` counts dense
    row copies (promotion's extraction and a hit's insert),
    ``cow_pages`` the paged tail-page copies. The paged layout's
    zero-copy claim is ``rows == 0`` across any number of hits."""
    return dict(_KV_COPIES)


def reset_kv_copy_counts() -> None:
    _KV_COPIES["rows"] = 0
    _KV_COPIES["cow_pages"] = 0


def _precompute_prefix(params: dict, prefix: torch.Tensor, prefix_len: int,
                       cfg: LlamaConfig) -> tuple[KVCache, torch.Tensor]:
    """Run the padded prefix (P,) through a fresh single-row scratch cache
    from position 0; returns the scratch (P rows) and the presence row of
    the real tokens only (causal attention keeps the padding out of the
    real rows' K/V)."""
    p = prefix.shape[0]
    scratch = KVCache.init(cfg, 1, p, prefix.device)
    _forward_cached(params, prefix[None, :], scratch, 0, cfg, select_pos=0)
    seen = torch.zeros((cfg.vocab_size,), dtype=torch.bool,
                       device=prefix.device)
    seen[prefix[:prefix_len].long()] = True
    return scratch, seen


def precompute_prefix(
    params: dict, tokens: list[int], cfg: LlamaConfig, adapter: int = -1,
    prompt_buckets: tuple[int, ...] = DEFAULT_PROMPT_BUCKETS,
) -> PrefixState:
    """Prefill a shared prefix once. The forward pads to the next
    ``prompt_buckets`` boundary, as the reference's does (one compile per
    bucket there); the rows are cut back to the exact token count, so
    the padded rows never reach a slot."""
    if adapter != -1:
        raise NotImplementedError(
            f"precompute_prefix(adapter={adapter}): adapters are not served "
            "by the PyTorch port yet")
    params = cast_params_for_compute(params, cfg)
    n = len(tokens)
    pad = next((b for b in sorted(prompt_buckets) if b >= n), n)
    device = params["embed"].device
    arr = torch.tensor(list(tokens) + [0] * (pad - n), dtype=torch.int64,
                       device=device)
    rows, seen = _precompute_prefix(params, arr, n, cfg)
    if pad != n:
        def cut(x):
            return None if x is None else x[:, :, :n].clone()

        rows = KVCache(k=cut(rows.k), v=cut(rows.v),
                       k_scale=cut(rows.k_scale), v_scale=cut(rows.v_scale))
    return PrefixState(rows=rows, tokens=tuple(tokens), presence=seen)


def _insert_prefix(state: BatchState, rows: KVCache, presence: torch.Tensor,
                   slot: int, cfg: LlamaConfig) -> None:
    """Copy prefilled prefix rows and their presence row into ``slot``:
    in place on the dense layout, scattered through the slot's freshly
    allocated pages on the paged one (the reference's
    ``_insert_prefix_rows_paged``, a row copy too). Suffix chunks and the
    activation follow through the chunked prefill."""
    _insert_rows(state, rows, slot, cfg)
    state.presence[slot] = presence


def extract_prefix_rows(state: BatchState, slot: int, p: int) -> KVCache:
    """The first ``p`` rows of a dense ``slot`` as a single-row
    ``KVCache`` (L, 1, p, Hkv, hd): the promotion's copy (the slot goes
    on decoding and is later reused)."""
    def cut(x):
        return None if x is None else x[:, slot:slot + 1, :p].clone()

    c = state.cache
    return KVCache(k=cut(c.k), v=cut(c.v), k_scale=cut(c.k_scale),
                   v_scale=cut(c.v_scale))


def _paged_release_hook(cb: ContinuousBatcher):
    """``PrefixCache.release_entry`` for a paged batcher, closed over a
    weak reference only: a cache that outlives its batcher must not keep
    the batcher (and its device pool) alive to return pages to a pool
    nobody allocates from any more."""
    wref = weakref.ref(cb)

    def release(entry) -> None:
        live = wref()
        if live is not None:
            live.pool.decref(entry.page_ids)

    return release


def _alias_slot_pages(state: BatchState, row: torch.Tensor,
                      presence: torch.Tensor, slot: int) -> None:
    """A paged prefix hit: the slot's table row (shared pages aliased in)
    and the prefix's presence row, written in place."""
    state.pages[slot] = row
    state.presence[slot] = presence


def _copy_page(state: BatchState, src: int, dst: int) -> None:
    """Copy one physical page, every layer, codes and scale planes alike:
    the copy-on-write of a partially filled shared tail page."""
    c = state.cache
    for x in (c.k, c.v, c.k_scale, c.v_scale):
        if x is not None:
            x[:, dst].copy_(x[:, src])
