"""Speculative decoding inside continuous batching, on the serving path.

Port of ``k8s_gpu_device_plugin_tpu/models/spec_batching.py``
(``spec_decode_step``, ``SpeculativeBatcher``). The slot engine keeps
the card busy across requests (``models/batching.py``); speculative
decoding (``models/speculative.py``) cuts each request's latency by
verifying ``gamma`` cheap draft proposals in one target forward. Per
round, for every decoding slot at once:

1. gamma draft decodes (T = 1) at each slot's own positions ->
   proposals (B, gamma);
2. one target forward over [last, d_1 .. d_{gamma-1}] (B, gamma): a
   verify window of the ragged-paged kernel, gamma tokens' K/V written
   and scored in one pass over the target's weights;
3. acceptance per slot: a greedy sampler keeps the longest run of
   proposals equal to the target's argmax plus the target's token at the
   cut; a sampled one runs rejection sampling (``_accept_round``), so
   every emitted token is distributed as the target's filtered one;
4. ``lengths += counts`` on both models' states; the rows past a slot's
   accepted ones are hidden by the position mask and overwritten later.

The batcher rides the rest of the serving path:

- **Paged KV** (``kv_layout="paged"``): the target writes and reads
  through the shared pool as the plain batcher does, the draft through a
  pool of its own with the same page geometry (``draft_kv_pages``; 0
  sizes it to the draft's dense-equivalent capacity). Admission reserves
  ``prompt + max_new + gamma`` rows in both pools (a round writes gamma
  rows past the accepted length and reads them back in the same round,
  so they must be real rows, not the trap page) and waits on pressure in
  either.
- **Prefix cache**: the target aliases cached pages (or copies dense
  rows) as the plain batcher does; the draft has no rows for the matched
  region, so it re-prefills them (the draft backfill) on the cold
  prefill's chunk grid, one chunk a step, before the slot's first
  mirrored chunk. The draft rows are the cold admission's, so streams
  are the same with the cache on and off.
- **The pipelined loop** (``pipeline_depth=1``): round t+1 is dispatched
  before round t is read back. The host only drops tokens (a slot
  retired since the dispatch, a tail past EOS, a stop sequence or the
  budget), and the flush-on-slot-reuse rule keeps a freed slot's lagging
  round from its next occupant.
- **One CUDA graph a round**: on a card the whole round (the gamma
  draft steps unrolled, the verify forward, the acceptance, the state
  updates, the draws from the shared generator) is captured once by
  ``DecodeGraph`` and replayed every round, as the plain decode step is.

Greedy streams equal the plain batcher's tokens up to float determinism
(the T = gamma verify and the T = 1 decode sum in different orders; in
f32 they are equal); inside the speculative batcher dense and paged,
cache on and off, and depth 0 and 1 are equal bit for bit in tokens and
logprobs. Sampled streams are target-distributed, not token-equal.

Observability: the ``on_spec_round`` metrics hook (the accepted-per-
round histogram), the ``draft_backfill`` span and the timeline's
``spec_rounds``, all on the host half of the round (its readback), as
the base batcher's are.

Left out (refused or absent, each in ROADMAP.md): tensor-parallel
drafts, adapters.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from k8s_gpu_device_plugin_torch.models.batching import (
    BatchState,
    ContinuousBatcher,
    RequestTooLargeError,
    _Request,
    init_batch_state,
    prefill_chunk,
    prefill_finish,
)
from k8s_gpu_device_plugin_torch.models.generate import (
    _forward_cached,
    kv_shards,
)
from k8s_gpu_device_plugin_torch.models.llama import (
    LlamaConfig,
    cast_params_for_compute,
)
from k8s_gpu_device_plugin_torch.models.paging import PagePool, kv_token_bytes
from k8s_gpu_device_plugin_torch.models.sampling import (
    Sampler,
    categorical,
    filtered_logits,
    filtered_probs,
    sampler_knobs,
    token_logprob,
)
from k8s_gpu_device_plugin_torch.models.speculative import _accept_round
from k8s_gpu_device_plugin_torch.ops.attention import attention_backend_plan
from k8s_gpu_device_plugin_torch.ops.ragged_paged_attention import MAX_VERIFY_T
from k8s_gpu_device_plugin_torch.parallel.tp_serving import (
    shard_serving_params,
)
from k8s_gpu_device_plugin_torch.utils.log import get_logger


def spec_decode_step(
    params_t: dict,
    params_d: dict,
    state: BatchState,        # the target's state: its lengths are the truth
    draft_state: BatchState,  # its cache and page table take part
    allowed: torch.Tensor,    # (B,) bool: running-set membership
    cfg_t: LlamaConfig,
    cfg_d: LlamaConfig,
    gamma: int,
    sampler: Sampler,
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One speculative round for every slot, in place (``copy_``) on both
    states: the target's lengths, last tokens and budgets, the draft's
    lengths (set to the target's). Returns (emitted (B, gamma) int64 with
    -1 past each slot's count, counts (B,) int64, logprobs (B, gamma) f32
    of the emitted tokens under the target's raw distribution).

    A slot takes part while it is active, allowed and has budget left;
    the others compute and discard. A dense slot out of the round writes
    at its top gamma rows, which no live window reaches under the gamma
    reservation; on the paged layout its table rows are zeroed on the
    device, so both models' writes land in the trap page 0 and a stale
    table can never reach a page since given to a neighbour. No host
    sync, no draw but from ``generator``: a CUDA graph captures it."""
    greedy = sampler.is_greedy
    was_active = state.active & allowed & (state.budget > 0)
    if cfg_t.kv_layout == "paged":
        cache_len = state.pages.shape[1] * cfg_t.kv_page_size
        keep = was_active[:, None]
        pages_t = torch.where(keep, state.pages, torch.zeros_like(state.pages))
        pages_d = torch.where(keep, draft_state.pages,
                              torch.zeros_like(draft_state.pages))
    else:
        cache_len = kv_shards(state.cache)[0].k.shape[2]
        pages_t = pages_d = None
    base = torch.where(was_active, state.lengths,
                       torch.full_like(state.lengths, cache_len - gamma))

    # 1. gamma draft proposals, each a T = 1 cached forward
    tok, d_toks, q_probs = state.last_token, [], []
    for j in range(gamma):
        logits = _forward_cached(params_d, tok[:, None], draft_state.cache,
                                 base + j, cfg_d, pages=pages_d)[:, -1]
        if greedy:
            tok = logits.argmax(dim=-1)
        else:
            fl = filtered_logits(logits, sampler)
            tok = categorical(fl, generator)
            q_probs.append(torch.softmax(fl, dim=-1))
        d_toks.append(tok)
    d_toks = torch.stack(d_toks, dim=1)                          # (B, gamma)

    # 2. one target forward over [last, d_1 .. d_{gamma-1}]: the verify
    # window (gamma == 1 is a plain decode)
    verify_in = torch.cat([state.last_token[:, None], d_toks[:, :-1]], dim=1)
    v_logits = _forward_cached(params_t, verify_in, state.cache, base, cfg_t,
                               pages=pages_t, verify=gamma > 1)

    # 3. acceptance per slot; position n of the row is the bonus
    idx = torch.arange(gamma, device=d_toks.device)[None, :]
    if greedy:
        pred = v_logits.argmax(dim=-1)                           # (B, gamma)
        n = torch.cumprod((d_toks == pred).long(), dim=1).sum(dim=1)
        counts = torch.clamp(n + 1, max=gamma)
        emit = torch.where(idx < n[:, None], d_toks, pred)
    else:
        p_probs = filtered_probs(v_logits, sampler)             # (B, g, V)
        n, bonus, counts = _accept_round(
            generator, d_toks, torch.stack(q_probs, dim=1), p_probs)
        emit = torch.where(idx < n[:, None], d_toks, bonus[:, None])
    logps = token_logprob(v_logits, emit)

    # 4. both states advance by the accepted counts
    counts = torch.where(was_active, counts, torch.zeros_like(counts))
    emitted = torch.where(was_active[:, None] & (idx < counts[:, None]),
                          emit, torch.full_like(emit, -1))
    last = emit.gather(1, torch.clamp(counts - 1, min=0)[:, None])[:, 0]
    new_len = state.lengths + counts.to(state.lengths.dtype)
    state.last_token.copy_(torch.where(was_active, last, state.last_token))
    # bookkeeping for the gate above: the host retires on budget and drops
    # a tail a round emitted past it; clamped, so a long run of accepted
    # proposals cannot take it below 0
    budget = torch.clamp(state.budget - counts.to(state.budget.dtype), min=0)
    state.budget.copy_(torch.where(was_active, budget, state.budget))
    state.lengths.copy_(new_len)
    draft_state.lengths.copy_(new_len)
    return emitted, counts, logps


class SpeculativeBatcher(ContinuousBatcher):
    """Continuous batching with a draft model proposing for every slot.

    Greedy samplers verify against the target's argmax; sampled ones
    (temperature, top-k, top-p) run rejection sampling per slot. The
    repetition penalty is refused (the filtered distributions would need
    the presence rows threaded through the round), and so are per-request
    samplers, logit bias and seeds. Chunked prefill is required: both
    models' caches prefill on the same chunk schedule.

    ``kv_layout="paged"`` pages both caches (``draft_kv_pages`` sizes the
    draft's pool; 0 = its dense-equivalent capacity), an attached
    ``prefix_cache`` serves the target while the draft re-prefills the
    matched region, and ``pipeline_depth=1`` (the default) dispatches
    round t+1 before round t is read back. The draft is given as its own
    params and config (it may share the target's tensors: a self-draft,
    or the target's first layers with its embedding, norm and head); it
    takes the target's layout and page size. gamma is 1 ..
    ``MAX_VERIFY_T``, the verify window's bound."""

    #: the draft and the verify distributions come from one static sampler
    per_request_sampler = False
    per_request_bias = False  # the round threads no bias planes
    per_request_seed = False  # nor per-row counter noise
    #: no preemption: resuming a slot would have to rebuild the draft's
    #: cache too, and the round has no per-request draw index; a
    #: scheduler that preempts is refused at construction
    supports_preemption = False

    def __init__(
        self,
        params: dict,
        cfg: LlamaConfig,
        draft_params: dict,
        draft_cfg: LlamaConfig,
        n_slots: int,
        max_len: int,
        gamma: int = 4,
        draft_kv_pages: int = 0,
        **kw,
    ):
        sampler = kw.get("sampler")
        if sampler is not None and sampler.repetition_penalty != 1.0:
            raise ValueError(
                "SpeculativeBatcher does not support repetition_penalty"
            )
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if kw.get("adapters") is not None:
            raise ValueError(
                "SpeculativeBatcher does not support LoRA adapters (the "
                "draft model has no stacks to mirror the target's)"
            )
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        if gamma > MAX_VERIFY_T:
            raise ValueError(
                f"gamma must be <= {MAX_VERIFY_T}: the target scores a "
                "round's proposals in one verify window of the kernel")
        # the gamma reservation takes part in _kv_need_tokens, and the
        # base constructor's graph capture waits for the draft state
        self.gamma = int(gamma)
        self.draft_state: "BatchState | None" = None
        super().__init__(params, cfg, n_slots, max_len, **kw)
        if not self.chunk:
            raise ValueError("SpeculativeBatcher requires chunked_prefill")
        # no incremental reservation or recycling: a round writes gamma
        # rows past the accepted length (a recycled page could sit under a
        # rejected proposal's rewrite), and the draft has no growth path
        self._incremental_reserve = False
        if self.cfg.tp > 1 and draft_cfg.n_kv_heads % self.cfg.tp:
            # the draft's cache shards on the target's mesh
            raise ValueError(
                f"tp={self.cfg.tp} does not divide the draft model's "
                f"n_kv_heads={draft_cfg.n_kv_heads}: the draft KV cache "
                "shards on the same mesh as the target — pick a tp from "
                "the common divisors of both head counts")
        # the draft rides the target's layout and mesh: both caches'
        # writes follow one schedule
        self.draft_cfg = replace(draft_cfg, kv_layout=self.cfg.kv_layout,
                                 kv_page_size=self.cfg.kv_page_size,
                                 tp=self.cfg.tp)
        if draft_params["embed"].device != self.device:
            raise ValueError(
                f"draft params on {draft_params['embed'].device}, target "
                f"on {self.device}: both models run on one device")
        self.draft_params = cast_params_for_compute(draft_params,
                                                    self.draft_cfg)
        if self.mesh is not None:
            self.draft_params = shard_serving_params(
                self.draft_params, self.draft_cfg, self.mesh)
        self.draft_attn_plan = attention_backend_plan(
            device=self.device, n_heads=self.draft_cfg.n_heads,
            n_kv_heads=self.draft_cfg.n_kv_heads,
            head_dim=self.draft_cfg.head_dim,
            kv_layout=self.draft_cfg.kv_layout,
            page_size=self.draft_cfg.kv_page_size,
            cache_quant=self.draft_cfg.cache_quant, chunk=self.chunk,
            window=self.draft_cfg.sliding_window, tp=self.draft_cfg.tp,
        )
        for mode, plan in self.draft_attn_plan.items():
            if plan["backend"] == "unsupported":
                raise ValueError(
                    f"draft {mode} attention cannot run on {self.device}: "
                    f"{plan['reason']}")
        # the draft's own pool: the target's page and slot geometry (the
        # tables are twins), the draft model's bytes. No prefix entry
        # ever shares a draft page: they free at slot retirement
        self.draft_pool: "PagePool | None" = None
        self._draft_slot_pages: dict[int, list[int]] = {}
        # rid -> draft pages reserved at admission, not yet installed
        self._draft_new_pages: dict[int, list[int]] = {}
        # slot -> pending draft-backfill chunk starts (prefix admissions;
        # drained one chunk a step by _prefill_one_chunk)
        self._draft_backfill: dict[int, list[int]] = {}
        n_draft_pages = 0
        if self.cfg.kv_layout == "paged":
            if draft_kv_pages < 0:
                raise ValueError(
                    f"draft_kv_pages must be >= 0 (0 = dense-equivalent "
                    f"pool), got {draft_kv_pages}"
                )
            per_slot = max_len // self.cfg.kv_page_size
            n_draft_pages = (int(draft_kv_pages) if draft_kv_pages > 0
                             else n_slots * per_slot + 1)
            self.draft_pool = PagePool(n_draft_pages, self.cfg.kv_page_size)
        elif draft_kv_pages:
            raise ValueError(
                f"draft_kv_pages={draft_kv_pages} has no effect under "
                "kv_layout='dense'")
        self.draft_state = init_batch_state(self.draft_cfg, n_slots, max_len,
                                            self.device, n_pages=n_draft_pages,
                                            mesh=self.mesh)
        # the draft's prefill finish samples a token nobody reads (its
        # call writes the draft's rows and activates its slot): greedy
        # knobs and a generator of its own, so that it never moves the
        # target's shared generator
        self._draft_knobs = self._h2d(sampler_knobs(Sampler()), torch.float32)
        self.draft_generator = torch.Generator(device=self.device)
        self.draft_generator.manual_seed(int(kw.get("seed", 0)))
        # acceptance accounting from the device counts: rounds with at
        # least one slot in them, proposals drafted, proposals accepted
        # (the bonus included; a tail the host drops stays counted)
        self._spec_rounds = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self.draft_backfill_chunks = 0
        if self._graph_wanted:
            self._capture_graph()

    def release_device_state(self) -> None:
        super().release_device_state()
        self.draft_state = None

    def _capture_graph(self) -> None:
        if self.draft_state is None:
            return  # the base constructor: the draft is not built yet
        super()._capture_graph()

    # --- admission rules ---

    def validate(self, prompt_len: int, max_new: int) -> None:
        # a round may write and read gamma rows past the accepted length
        if prompt_len + max_new + self.gamma > self.max_len:
            raise RequestTooLargeError(
                f"prompt {prompt_len} + max_new {max_new} + gamma "
                f"{self.gamma} exceeds slot capacity {self.max_len}",
                prompt_tokens=prompt_len, max_new=max_new,
                limit=self.max_len - self.gamma,
            )
        super().validate(prompt_len, max_new)
        if self.draft_pool is not None:
            # the draft pool is a second admission wall
            need = self.draft_pool.pages_for_tokens(
                self._kv_need_tokens(prompt_len, max_new))
            if need > self.draft_pool.capacity:
                self._count_kv_rejection("request_too_large")
                raise RequestTooLargeError(
                    f"request needs {need} draft KV pages but the draft "
                    f"pool holds {self.draft_pool.capacity}; raise "
                    "draft_kv_pages or shrink the request",
                    prompt_tokens=prompt_len, max_new=max_new,
                    limit=self.draft_pool.capacity * self.draft_pool.page_size,
                )

    def validate_resume(self, resume_out, resume_logp, max_new,
                        prefix=None) -> "tuple[list, list]":
        """No resume path: the draft cache cannot be rebuilt from emitted
        tokens, and rounds share one sampler with no per-request draw
        index."""
        if resume_out:
            raise ValueError(
                "stream resume (resume_out) is not supported with "
                "speculative batching"
            )
        return [], []

    def submit(self, prompt, max_new, stop=None, sampler=None, seed=None,
               logit_bias=None, prefix=None, **unserved) -> int:
        self.validate_resume(unserved.get("resume_out"),
                             unserved.get("resume_logp"), max_new,
                             prefix=prefix)
        if unserved.get("kv_pages") is not None:
            raise ValueError(
                "kv_pages install is not supported with speculative "
                "batching (a KV transfer resumes a stream, and speculative "
                "batching does not resume)"
            )
        if sampler is not None:
            raise ValueError(
                "per-request samplers are not supported with speculative "
                "batching (draft and target must share one sampler)"
            )
        if logit_bias:
            raise ValueError(
                "logit_bias is not supported with speculative batching"
            )
        if seed is not None:
            raise ValueError(
                "per-request seeds are not supported with speculative "
                "batching (the round threads no per-row key streams)"
            )
        # a prefix (manual, or a cache hit at admission) serves the
        # target's rows; the draft re-prefills the region itself
        return super().submit(prompt, max_new, stop=stop, prefix=prefix,
                              **unserved)

    # --- paged KV: the draft pool mirrors every admission ---

    def _kv_need_tokens(self, prompt_len: int, max_new: int) -> int:
        # a round writes up to gamma rows past the accepted length and its
        # attention reads them back: they must be real rows
        return prompt_len + max_new + self.gamma

    def _reserve_pages(self, req: _Request) -> bool:
        need_d = 0
        if self.draft_pool is not None:
            need_d = self.draft_pool.pages_for_tokens(
                self._kv_need_tokens(len(req.prompt), req.max_new))
            if need_d > self.draft_pool.free_pages:
                # nothing to reclaim: no prefix entry pins a draft page,
                # so pages free only as slots retire; wait at the head of
                # the queue as under target pressure
                if not req.defer_counted:
                    req.defer_counted = True
                    self._count_kv_rejection("pool_pressure")
                    get_logger().debug(
                        "admission deferred: draft KV pool pressure (rid %d "
                        "needs %d pages, %d free)", req.rid, need_d,
                        self.draft_pool.free_pages)
                return False
        if not super()._reserve_pages(req):
            return False
        if self.draft_pool is not None:
            # one engine thread: the free-list check above still holds
            self._draft_new_pages[req.rid] = self.draft_pool.alloc(need_d)
        return True

    def _install_pages(self, req: _Request, slot: int) -> None:
        super()._install_pages(req, slot)
        if self.draft_pool is None:
            return
        if slot in self._draft_slot_pages:
            raise RuntimeError(f"slot {slot} still holds draft pages")
        ids = self._draft_new_pages.pop(req.rid, [])
        self._draft_slot_pages[slot] = ids
        width = self.draft_state.pages.shape[1]
        self.draft_state.pages[slot] = self._h2d(
            ids + [0] * (width - len(ids)), torch.int32)

    def _release_slot_pages(self, slot: int,
                            req: "_Request | None" = None) -> None:
        super()._release_slot_pages(slot, req)
        # a slot cancelled mid-backfill must not hand its queue to the
        # next occupant (every retire and cancel path comes here)
        self._draft_backfill.pop(slot, None)
        if self.draft_pool is not None:
            ids = self._draft_slot_pages.pop(slot, None)
            if ids:
                self.draft_pool.decref(ids)

    def kv_stats(self) -> dict:
        """The target's stats plus the draft cache's reservation (and its
        pool's occupancy when paged): ``reserved_bytes`` covers both
        models' caches, so speculative and plain replicas compare."""
        s = super().kv_stats()
        draft_cfg = getattr(self, "draft_cfg", None)
        if draft_cfg is None:
            return s  # mid-construction: the draft is not built yet
        tb = kv_token_bytes(draft_cfg)
        if self.draft_pool is None:
            draft = {"layout": "dense",
                     "reserved_bytes": self.n_slots * self.max_len * tb}
        else:
            dp = self.draft_pool
            draft = {
                "layout": "paged",
                "page_size": dp.page_size,
                "pages_total": dp.capacity,
                "pages_in_use": dp.in_use,
                "pages_free": dp.free_pages,
                "reserved_bytes": dp.n_pages * dp.page_size * tb,
            }
        s["target_reserved_bytes"] = s["reserved_bytes"]
        s["draft_reserved_bytes"] = draft["reserved_bytes"]
        s["reserved_bytes"] += draft["reserved_bytes"]
        s["draft"] = draft
        for shard in s.get("shards", ()):
            # tp > 1: a shard's reserved bytes mean what the aggregate
            # means (target and draft), so the shard gauges sum to it
            per_shard = draft["reserved_bytes"] // self.cfg.tp
            shard["draft_reserved_bytes"] = per_shard
            shard["reserved_bytes"] += per_shard
        return s

    def spec_stats(self) -> dict:
        """Acceptance for ``/v1/health``: ``tokens_drafted`` counts gamma
        proposals per slot a round ran for, ``tokens_accepted`` the
        device's accepted counts (the bonus included)."""
        drafted, rounds = self._spec_drafted, self._spec_rounds
        slot_rounds = drafted // self.gamma
        return {
            "gamma": self.gamma,
            "rounds": rounds,
            "tokens_drafted": drafted,
            "tokens_accepted": self._spec_accepted,
            "acceptance_rate": (
                self._spec_accepted / drafted if drafted else 0.0),
            # mean accepted tokens a slot a round (1 .. gamma): near gamma
            # says raise it, near 1 that the draft does not pay
            "accepted_per_round": (
                self._spec_accepted / slot_rounds if slot_rounds else 0.0),
        }

    # --- every prefill mirrored onto the draft ---

    def _apply_prefill_chunk(self, chunk, start, slot) -> None:
        super()._apply_prefill_chunk(chunk, start, slot)
        prefill_chunk(self.draft_params, self.draft_state, chunk, start, slot,
                      self.draft_cfg)

    def _apply_prefill_finish(self, chunk, fstart, plen, slot):
        tok, logp = super()._apply_prefill_finish(chunk, fstart, plen, slot)
        # the same chunk through the draft, for its rows and its slot's
        # activation; its token is not read
        prefill_finish(self.draft_params, self.draft_state, chunk, fstart,
                       plen, slot, self.draft_cfg, self._draft_knobs,
                       self.prefilling[slot].max_new, self.draft_generator)
        return tok, logp

    def _on_prefill_scheduled(self, req, slot: int, start: int) -> None:
        """The draft backfill of a prefix admission: the target holds rows
        [0, start) from the prefix (aliased pages or copied rows), the
        draft none of them. Queue their re-prefill through the draft on
        the cold path's chunk grid (chunks at 0, C, 2C, ... and a final
        window back-scheduled to end at ``start``), so the draft's rows
        are a cold admission's. It drains one chunk a step, the pace the
        chunk scheduler gives the target's own prefill."""
        self._draft_backfill.pop(slot, None)
        if start <= 0:
            return
        c = self.chunk
        starts, p = [], 0
        while p + c < start:
            starts.append(p)
            p += c
        starts.append(max(0, start - c))
        self._draft_backfill[slot] = starts

    def _prefill_one_chunk(self) -> None:
        # the oldest mid-prefill slot's backfill goes first: its mirrored
        # suffix chunks attend draft rows [0, start)
        if self.prefilling:
            slot = next(iter(self.prefilling))
            pending = self._draft_backfill.get(slot)
            if pending:
                req = self.prefilling[slot]
                s = pending.pop(0)
                if not pending:
                    del self._draft_backfill[slot]
                span = None
                if req.span is not None:
                    span = self.tracer.span(
                        "draft_backfill", component="serving",
                        parent=req.span, start=s, tokens=self.chunk)
                try:
                    # a window past ``start`` holds real prompt tokens the
                    # mirrored chunks rewrite identically; padding rows lie
                    # past the prompt, never attended before they are
                    # written
                    rest = req.prompt[s:s + self.chunk]
                    chunk = self._h2d(
                        rest + [0] * (self.chunk - len(rest)), torch.int64)
                    prefill_chunk(self.draft_params, self.draft_state, chunk,
                                  s, slot, self.draft_cfg)
                finally:
                    if span is not None:
                        span.end()
                self.draft_backfill_chunks += 1
                return
        super()._prefill_one_chunk()

    # --- the decode seams: one draft-and-verify round a step ---

    def _eager_step(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """:func:`spec_decode_step` over the persistent inputs (what the
        graph captures)."""
        return spec_decode_step(
            self.params, self.draft_params, self.state, self.draft_state,
            self._allowed, self.cfg, self.draft_cfg, self.gamma, self.sampler,
            self.generator)

    # graftlint: hot-path
    def _decode_dispatch(self) -> tuple:
        # the gamma reservation: a running slot has len(out) < max_new,
        # so its round's rows end inside the slot
        for req in self.running.values():
            if len(req.prompt) + len(req.out) + self.gamma > self.max_len:
                raise RuntimeError(
                    f"request {req.rid}: the gamma reservation is violated")
        return super()._decode_dispatch()

    # graftlint: hot-path
    def _apply_decode_result(self, arrs: tuple) -> int:
        emitted, counts, logps = (x.tolist() for x in arrs)
        # acceptance from the device counts, not the running map: a slot
        # retired or cancelled since the dispatch (the pipeline's lag)
        # really drafted and scored its proposals
        accepted = [c for c in counts if c > 0]
        n_emitted = 0
        # a round's accepted tokens reach the client as one burst: the
        # first carries the round's gap, the rest about 0
        track, now = self._token_tracking()
        for slot, req in list(self.running.items()):
            if req.timeline is not None and counts[slot] > 0:
                req.timeline.spec_rounds += 1
            for j in range(counts[slot]):
                tok = emitted[slot][j]
                if tok < 0:
                    break
                n_emitted += 1
                req.out.append(tok)
                req.out_logp.append(logps[slot][j])
                if track:
                    self._mark_emitted_token(req, now)
                self._finish_if_done(req)
                if req.rid in self.done:
                    break  # EOS, a stop or the budget mid-round: drop the tail
        if accepted:
            self._spec_rounds += 1
            self._spec_drafted += self.gamma * len(accepted)
            self._spec_accepted += sum(accepted)
            if self.metrics is not None:
                self.metrics.on_spec_round(self.gamma, accepted)
        self.decode_tokens += n_emitted
        return n_emitted

    def _inflight_covers_rest(self, inflight) -> bool:
        # a round emits up to gamma tokens a slot: predicting with gamma
        # spares a round past every budget; when acceptance falls short,
        # step() dispatches again after the read
        return all(
            len(req.out) + (self.gamma if slot in inflight.slots else 0)
            >= req.max_new
            for slot, req in self.running.items()
        )
