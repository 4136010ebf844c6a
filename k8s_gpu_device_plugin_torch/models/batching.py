"""Continuous batching for serving: slots, prefill, the decode loop.

Port of ``k8s_gpu_device_plugin_tpu/models/batching.py``: the dense and
the paged KV layout (bf16/f32, int8 codes or packed int4 codes; float or
weight-only int8/int4 quantized params), bucketed prefill-then-insert
(``prefill_insert``, ``chunked_prefill=0``, the default) and chunked
prefill (``prefill_chunk`` / ``prefill_finish``), FIFO admission,
per-request logit bias and seeds, and the pipelined decode loop
(``pipeline_depth=1``, the default; 0 is the synchronous loop). A slot
is one concurrent sequence: on the dense layout its reserved cache rows,
on the paged one a page-table row over a shared pool
(``models/paging.py``), reserved at admission for the request's worst
case and released when it retires or is cancelled. Every slot decodes
at its own absolute position, and the decode step never changes shape
(empty slots compute and discard).

The device state (:class:`BatchState`) and every per-slot input of the
decode step (membership mask, sampler knobs, the logit-bias plane, the
seeds, the EOS id) are persistent tensors updated in place: admission,
retirement and cancellation write them, the steady decode loop uploads
nothing. On a CUDA device that lets the batcher capture the decode step
once as a CUDA graph (:class:`DecodeGraph`, the port's counterpart of
the reference's jitted step) and replay it every token; on the CPU,
where the caller asked for it, the step runs eagerly.

The pipelined loop dispatches step t+1 before it reads step t back, so
the host's per-token work overlaps the device's next step. Its rules
are the reference's: the in-flight step is flushed before an admission
that reuses one of its live slots, a slot retired or cancelled since the
dispatch (and a -1 sentinel) is skipped on readback, and when the
budgets show that the in-flight step retires every running request it
is read back without a dispatch ahead. Greedy and seeded streams are
the same bit for bit at either depth; so are unseeded ones as long as
no admission waits on a retirement (the pipeline sees a retirement one
step later, so such an admission, and the shared generator's draws
behind it, come one step later).

Constructor and ``submit`` arguments the reference has and the port does
not serve yet (adapters, prefix cache, scheduler, tensor parallelism,
fault injection, ...) are refused when set, never ignored; so is the
paged layout under a sliding window (incremental reservation and page
recycling are not ported yet).
"""

from __future__ import annotations

import threading
import time
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
    returns its (emitted, logprobs); a replay runs the same kernels on
    the same storage and leaves its results in :attr:`outputs`.

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

    def replay(self) -> tuple[torch.Tensor, torch.Tensor]:
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
    prompt: list[int]
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
    emitted: torch.Tensor
    logps: torch.Tensor
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
    queue until a retirement frees pages.

    On a CUDA device the decode step is captured once as a CUDA graph
    (:class:`DecodeGraph`) at construction; ``decode_graph=False`` runs
    it eagerly instead (a measurement's yardstick). On the CPU it runs
    eagerly and ``decode_graph=True`` raises."""

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
                    "(ROADMAP A.4); serve kv_layout='dense'"
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
        # pinned landing buffers for the readback, two so that step t+1's
        # copy never lands on step t's before the host read it
        self._landing = [
            (torch.empty((n_slots,), dtype=torch.int64, pin_memory=True),
             torch.empty((n_slots,), dtype=torch.float32, pin_memory=True))
            for _ in range(2)] if on_cuda else None
        self._refresh_slot_inputs()  # every slot out, the default knobs
        self.graph: "DecodeGraph | None" = None
        if on_cuda and decode_graph is not False:
            # captured while no slot is allowed: the warm-up steps
            # compute and discard, writing only the trap rows
            self.graph = DecodeGraph(self._eager_step, self.generator, dev)

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
        **unserved,
    ) -> int:
        """Queue a request; returns its id."""
        _refuse("submit", unserved, _UNSERVED_SUBMIT)
        prompt = self.validate_prompt(prompt)
        self.validate(len(prompt), max_new)
        bias = self.validate_bias(logit_bias)
        seed = self.validate_seed(seed)
        rid = self._next_rid
        self._next_rid += 1
        self.pending.append(_Request(
            rid, prompt, int(max_new),
            stop=tuple(tuple(int(t) for t in s) for s in (stop or ()) if s),
            sampler=sampler, bias=bias, seed=seed,
            t_submit=time.perf_counter(),
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
        self.state.pages[slot] = self._h2d(row, torch.int32)

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
            if self.pool is not None and not self._reserve_pages(req):
                break  # head-of-line wait: pages free as slots retire
            self.pending.pop(0)
            req.slot = slot = free.pop(0)
            if self.pool is not None:
                self._install_pages(req, slot)
            self._open_slot(req, slot)
            if self.chunk:
                self.prefilling[slot] = req
                self._prefill_pos[slot] = 0
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
            self._first_token(req, slot, tok, logp, t0)

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
        to running."""
        self._wait_prefill(self._done_event(), t0)
        req.out.append(int(tok[0]))
        req.out_logp.append(float(logp[0]))
        req.t_first_tok = time.perf_counter()
        self.running[slot] = req
        self._slots_dirty = True
        self._finish_if_done(req)

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
        t0 = time.perf_counter()
        if start + c < plen:  # intermediate chunk, all real tokens
            chunk = self._h2d(req.prompt[start:start + c], torch.int64)
            prefill_chunk(self.params, self.state, chunk, start, slot,
                          self.cfg)
            # nothing reads this chunk back: wait for it here, or its
            # device time would be charged to the next decode step
            self._wait_prefill(self._done_event(), t0)
            self._prefill_pos[slot] = start + c
            return
        fstart = max(0, plen - c)
        rest = req.prompt[fstart:]
        chunk = self._h2d(rest + [0] * (c - len(rest)), torch.int64)
        tok, logp = prefill_finish(
            self.params, self.state, chunk, fstart, plen, slot, self.cfg,
            self._req_knobs(req), req.max_new, self.generator,
            bias=self._bias[slot:slot + 1],
            seeds=self.state.seeds[slot:slot + 1],
        )
        del self.prefilling[slot], self._prefill_pos[slot]
        self._first_token(req, slot, tok, logp, t0)

    # --- the decode loop ---

    def _eager_step(self) -> tuple[torch.Tensor, torch.Tensor]:
        """:func:`decode_step` over the persistent inputs (what the graph
        captures)."""
        return decode_step(self.params, self.state, self._allowed, self._eos,
                           self.cfg, self._knobs, self.generator,
                           bias=self._bias, seeds=self.state.seeds)

    def _dispatch_decode(self) -> None:
        """Enqueue one decode step without waiting for it: its results
        start for the host at once (pinned buffers, an event) and wait in
        ``_inflight`` with the slots it counted live."""
        t0 = time.perf_counter()
        self._refresh_slot_inputs()
        if self.graph is not None:
            emitted, logps = self.graph.replay()
        else:
            emitted, logps = self._eager_step()
        event = None
        if self._landing is not None:
            host_tok, host_logp = self._landing[self._step_no % 2]
            host_tok.copy_(emitted, non_blocking=True)
            host_logp.copy_(logps, non_blocking=True)
            emitted, logps = host_tok, host_logp
            event = torch.cuda.Event()
            event.record()
        self._inflight = _Inflight(self._step_no, emitted, logps, event,
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
        emitted = inflight.emitted.tolist()
        logps = inflight.logps.tolist()
        self.decode_s += time.perf_counter() - t0
        return self._apply_emitted(emitted, logps)

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
