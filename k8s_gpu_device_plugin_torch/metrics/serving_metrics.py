"""Prometheus metrics for the serving engine (continuous batching).

The port's copy of ``k8s_gpu_device_plugin_tpu/metrics/serving_metrics.py``
on the port's own registry (``metrics/exposition.py``; the card's
machine has no ``prometheus_client``): the same families, types, label
names and buckets after the prefix, whose default is ``gpu_serving``. A
``ServingMetrics`` the batcher drives, so ``GET /metrics`` sees queue
depth, slot occupancy, token throughput, latency distributions with
trace-id exemplars, the KV pool and the live roofline. Optional and
injected: the batcher works identically with ``metrics=None``.

The families of the adapter residency (A.10) and of the per-shard KV
view (tensor parallelism, A.12) are registered, as the reference
registers them, but nothing sets them yet: the port serves neither.
"""

from __future__ import annotations

import time

from k8s_gpu_device_plugin_torch.metrics.exposition import (
    Counter,
    Gauge,
    Histogram,
)

# Serving latency buckets: TTFT spans queue wait + prefill (ms..s);
# inter-token is the per-step decode cadence (sub-ms..s with chunked
# prefill interleaving). One ladder covers both with sub-ms resolution.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, float("inf"),
)


class ServingMetrics:
    """Registers once on ``registry`` (a server's own); updated by the
    ContinuousBatcher. Family names are fixed, so two live instances on
    the same registry collide: :meth:`close` unregisters them."""

    #: the latency observers accept an optional exemplar id (a second
    #: positional) — the batcher checks this instead of try/excepting,
    #: so duck-typed fakes with single-arg observers keep working
    supports_exemplars = True

    def __init__(self, registry, prefix: str = "gpu_serving"):
        self._registry = registry
        self.tokens_total = Counter(
            f"{prefix}_generated_tokens_total",
            "Tokens emitted across all requests",
            registry=registry,
        )
        self.requests_submitted = Counter(
            f"{prefix}_requests_submitted_total",
            "Requests accepted into the queue",
            registry=registry,
        )
        self.requests_finished = Counter(
            f"{prefix}_requests_finished_total",
            "Requests retired, by reason",
            ["reason"],  # eos | budget | stop | cancelled | rejected
            registry=registry,
        )
        self.prefill_chunks = Counter(
            f"{prefix}_prefill_chunks_total",
            "Prefill chunks executed (chunked admission only)",
            registry=registry,
        )
        # Prefill work by PROVENANCE: chunks say how many dispatches ran,
        # this says how many prompt tokens they covered — and how many
        # were served from prefilled prefix rows instead (the prefix
        # cache's savings, directly observable as the computed/reused
        # split instead of inferred from chunk counts).
        self.prefill_tokens = Counter(
            f"{prefix}_prefill_tokens_total",
            "Prompt tokens prefilled, by provenance",
            ["source"],  # computed | prefix_reused
            registry=registry,
        )
        # Automatic prefix cache (serving/prefix_cache.py): request-level
        # hit/miss (one disposition per request, counted at admission),
        # LRU evictions, tokens served from cache, and HBM residency.
        self.prefix_hits = Counter(
            f"{prefix}_prefix_cache_hits_total",
            "Requests admitted with a cached prefix",
            registry=registry,
        )
        self.prefix_misses = Counter(
            f"{prefix}_prefix_cache_misses_total",
            "Requests admitted with no usable cached prefix",
            registry=registry,
        )
        self.prefix_evictions = Counter(
            f"{prefix}_prefix_cache_evictions_total",
            "Cached prefixes evicted (LRU, HBM byte budget)",
            registry=registry,
        )
        self.prefix_tokens_saved = Counter(
            f"{prefix}_prefix_cache_tokens_saved_total",
            "Prompt tokens whose prefill was skipped via a cache hit",
            registry=registry,
        )
        self.prefix_resident_bytes = Gauge(
            f"{prefix}_prefix_cache_resident_bytes",
            "HBM bytes held by cached prefixes",
            registry=registry,
        )
        self.prefix_entries = Gauge(
            f"{prefix}_prefix_cache_entries",
            "Cached prefixes currently resident",
            registry=registry,
        )
        # Paged KV cache (models/paging.py; kv_layout="paged"): pool
        # occupancy, internal fragmentation (allocated page capacity not
        # covered by live tokens), and admission rejections by reason
        # (pool_pressure = transient deferral, request_too_large = the
        # request outsizes the whole pool). kv_reserved_bytes is set by
        # BOTH layouts (dense: the static slot reservation; paged: the
        # pool arrays), so flipping --kvLayout shows up as a directly
        # comparable HBM number on /metrics.
        self.kv_pages_total = Gauge(
            f"{prefix}_kv_pages_total",
            "Allocatable KV pool pages (paged layout; trap page excluded)",
            registry=registry,
        )
        self.kv_pages_in_use = Gauge(
            f"{prefix}_kv_pages_in_use",
            "KV pool pages currently referenced by slots or cached prefixes",
            registry=registry,
        )
        self.kv_page_fragmentation_pct = Gauge(
            f"{prefix}_kv_page_fragmentation_pct",
            "Allocated KV page capacity not covered by live tokens (%)",
            registry=registry,
        )
        self.kv_admission_rejected = Counter(
            f"{prefix}_kv_admission_rejected_total",
            "Admissions refused or deferred by the KV pool, by reason",
            ["reason"],  # pool_pressure | request_too_large
            registry=registry,
        )
        self.kv_pages_recycled = Counter(
            f"{prefix}_kv_pages_recycled_total",
            "Out-of-window KV pages returned to the pool mid-request "
            "(sliding-window serving: a page every live row's window "
            "has slid past frees without waiting for retirement)",
            registry=registry,
        )
        self.prefill_chunks_deferred = Counter(
            f"{prefix}_prefill_chunks_deferred_total",
            "Prefill chunks postponed mid-prompt, by reason (incremental "
            "reservation: pool pressure defers the next chunk, never "
            "the request)",
            ["reason"],  # pool_pressure
            registry=registry,
        )
        self.kv_reserved_bytes = Gauge(
            f"{prefix}_kv_reserved_bytes",
            "Static HBM held by the KV cache arrays (both layouts)",
            registry=registry,
        )
        # Tensor-parallel serving (tp>1 only — at tp=1 these series are
        # never emitted, so the single-chip gauge surface stays byte-
        # comparable across the flag flip): each shard's slice of the KV
        # reservation/occupancy. Page COUNTS are identical across shards
        # (one replicated host-side page table); the BYTES divide by tp.
        # Label cardinality is bounded by the mesh size.
        self.kv_shard_reserved_bytes = Gauge(
            f"{prefix}_kv_shard_reserved_bytes",
            "Static KV HBM held on one tensor-parallel shard",
            ["shard"],
            registry=registry,
        )
        self.kv_shard_pages_in_use = Gauge(
            f"{prefix}_kv_shard_pages_in_use",
            "KV pool pages referenced on one tensor-parallel shard "
            "(identical across shards by design — divergence means a "
            "table/pool bug)",
            ["shard"],
            registry=registry,
        )
        self.kv_shard_in_use_bytes = Gauge(
            f"{prefix}_kv_shard_in_use_bytes",
            "Allocated KV page bytes resident on one tensor-parallel shard",
            ["shard"],
            registry=registry,
        )
        # shard -> physical chip mapping (info-style, value always 1):
        # a NEW series rather than a chip label on the gauges above, so
        # their label sets — pinned byte-comparable in the tp tests —
        # never change. Written only when the engine knows its allocated
        # device set (device/allocation.py).
        self.kv_shard_chip = Gauge(
            f"{prefix}_kv_shard_chip",
            "Physical GPU behind one tensor-parallel shard (1 = mapped)",
            ["shard", "chip"],
            registry=registry,
        )
        # Attention-backend routing (ops/attention.py's plan): which
        # backend each serving mode (decode / verify / prefill) routes
        # through, as 1/0 per (mode, backend) pair; fixed cardinality
        # (3 modes x 2 backends).
        self.decode_attn_backend = Gauge(
            f"{prefix}_decode_attn_backend",
            "Active attention backend per serving mode (1 = routed "
            "there; cuda = the ragged paged attention kernel, plain = "
            "the PyTorch version)",
            ["mode", "backend"],
            registry=registry,
        )
        # Speculative decoding (models/spec_batching.py): rounds run,
        # tokens the draft proposed vs tokens the verify accepted (bonus
        # token included), and the per-slot-round acceptance-length
        # distribution — the signal for picking gamma: a histogram mass
        # near gamma says raise it, mass at 1 says the draft isn't
        # earning its keep. The spec path used to export NOTHING;
        # acceptance rate was invisible in production.
        self.spec_rounds = Counter(
            f"{prefix}_spec_rounds_total",
            "Speculative draft+verify rounds executed",
            registry=registry,
        )
        self.spec_tokens_drafted = Counter(
            f"{prefix}_spec_tokens_drafted_total",
            "Draft proposals scored by verify rounds (gamma per active "
            "slot-round)",
            registry=registry,
        )
        self.spec_tokens_accepted = Counter(
            f"{prefix}_spec_tokens_accepted_total",
            "Tokens accepted per verify round (bonus token included)",
            registry=registry,
        )
        self.spec_accepted_per_round = Histogram(
            f"{prefix}_spec_accepted_per_round",
            "Accepted tokens per slot per verify round",
            buckets=(1, 2, 3, 4, 6, 8, 12, 16, float("inf")),
            registry=registry,
        )
        # SLO scheduling (serving/scheduler.py): how long admission
        # makes a request wait, whether deadlines held (misses + how
        # late), which tenants' tokens were USEFUL (goodput = tokens of
        # requests that finished by their deadline), and the scheduler's
        # two interventions (preemption, overload rejection). Label
        # cardinality is bounded: tenants are operator-configured,
        # priority is a single digit.
        self.sched_queue_wait_seconds = Histogram(
            f"{prefix}_sched_queue_wait_seconds",
            "Time a request waited between submission and slot assignment",
            buckets=LATENCY_BUCKETS,
            registry=registry,
        )
        self.sched_deadline_misses = Counter(
            f"{prefix}_sched_deadline_misses_total",
            "Requests that finished after their deadline, by tenant",
            ["tenant"],
            registry=registry,
        )
        self.sched_deadline_overrun_seconds = Histogram(
            f"{prefix}_sched_deadline_overrun_seconds",
            "How far past its deadline a missing request finished",
            buckets=LATENCY_BUCKETS,
            registry=registry,
        )
        self.sched_goodput_tokens = Counter(
            f"{prefix}_sched_goodput_tokens_total",
            "Tokens of requests that met their deadline (or had none), "
            "by tenant and priority class",
            ["tenant", "priority"],
            registry=registry,
        )
        self.sched_preemptions = Counter(
            f"{prefix}_sched_preemptions_total",
            "Decoding slots evicted for a higher class (slo policy)",
            registry=registry,
        )
        self.sched_rejected = Counter(
            f"{prefix}_sched_rejected_total",
            "Requests refused by the scheduler, by reason",
            ["reason"],  # queue_full | defer_budget
            registry=registry,
        )
        self.queue_depth = Gauge(
            f"{prefix}_queue_depth",
            "Requests waiting for a slot",
            registry=registry,
        )
        self.slots_active = Gauge(
            f"{prefix}_slots_active",
            "Slots currently decoding",
            registry=registry,
        )
        self.slots_prefilling = Gauge(
            f"{prefix}_slots_prefilling",
            "Slots mid-chunked-prefill",
            registry=registry,
        )
        self.tokens_per_second = Gauge(
            f"{prefix}_tokens_per_second",
            "Decode throughput over the last observation window",
            registry=registry,
        )
        # Latency DISTRIBUTIONS for the serving hot path (the counters
        # above say how much; these say how long a user waits): TTFT is
        # submit -> first sampled token (queue wait + prefill included),
        # inter-token is the gap between consecutive tokens of ONE
        # request (what a streaming client perceives between events).
        self.ttft_seconds = Histogram(
            f"{prefix}_ttft_seconds",
            "Time from request submission to its first generated token",
            buckets=LATENCY_BUCKETS,
            registry=registry,
        )
        self.inter_token_seconds = Histogram(
            f"{prefix}_inter_token_seconds",
            "Gap between consecutive generated tokens of one request",
            buckets=LATENCY_BUCKETS,
            registry=registry,
        )
        # Per-request latency ATTRIBUTION (obs/attribution.py): every
        # retired request's wall time partitions into phases that sum to
        # it (queue_wait -> prefill -> decode, repeating across
        # preemptions); each phase lands here, exemplar-tagged with the
        # request's trace id, so "p99 TTFT regressed" decomposes into
        # WHICH phase grew — and pivots to a concrete trace. Label
        # cardinality is the fixed phase set.
        self.request_phase_seconds = Histogram(
            f"{prefix}_request_phase_seconds",
            "Wall time one retired request spent in one lifecycle phase",
            ["phase"],  # queue_wait | prefill | decode
            buckets=LATENCY_BUCKETS,
            registry=registry,
        )
        # Live serving MFU / roofline accounting (metrics/roofline.py):
        # prefill model-FLOPs + decode HBM-stream priced from the config
        # math against the card's spec-sheet peaks, accumulated per ~1s
        # window of busy time. The gauges answer "is the chip
        # underfed or at the bandwidth wall"; the counters make
        # tokens-per-TFLOP derivable over any scrape interval.
        self.serving_mfu = Gauge(
            f"{prefix}_mfu_pct",
            "Model FLOPs utilization over the last busy window (% of "
            "the slice's spec-sheet peak)",
            registry=registry,
        )
        self.hbm_bw_util = Gauge(
            f"{prefix}_hbm_bw_util_pct",
            "Decode HBM-roofline bandwidth utilization over the last "
            "busy window (% of the slice's spec-sheet bandwidth)",
            registry=registry,
        )
        self.model_flops = Counter(
            f"{prefix}_model_flops_total",
            "Model FLOPs served (prefill + decode, config-math priced)",
            registry=registry,
        )
        self.hbm_bytes = Counter(
            f"{prefix}_model_hbm_bytes_total",
            "Decode HBM bytes streamed (weights + live KV, roofline "
            "model)",
            registry=registry,
        )
        self.tenant_flops = Counter(
            f"{prefix}_tenant_model_flops_total",
            "Model FLOPs attributed per tenant at request retirement "
            "(divide sched_goodput_tokens_total by this for "
            "goodput-per-FLOP)",
            ["tenant"],
            registry=registry,
        )
        # Decode-pipeline observability: how long the host spends
        # ENQUEUEING a step vs WAITING for one (dispatch time that grows
        # toward readback time means the overlap stopped hiding the
        # host), and how often membership changes flush the in-flight
        # step early (admissions/cancels interrupting steady state).
        self.decode_dispatch_seconds = Histogram(
            f"{prefix}_decode_dispatch_seconds",
            "Time to enqueue one decode step (pipelined mode)",
            buckets=LATENCY_BUCKETS,
            registry=registry,
        )
        self.decode_readback_seconds = Histogram(
            f"{prefix}_decode_readback_seconds",
            "Time to read one decode step back and run its host work",
            buckets=LATENCY_BUCKETS,
            registry=registry,
        )
        self.pipeline_flushes = Counter(
            f"{prefix}_pipeline_flushes_total",
            "In-flight decode steps flushed early on membership changes",
            registry=registry,
        )
        # Engine crash recovery (serving/supervisor.py): restarts of
        # the batcher behind a live HTTP surface, and what each one
        # carried over — queued requests replayed in admission order,
        # in-flight requests resumed through the preemption fold. A
        # nonzero restart rate is the first thing a fleet dashboard
        # should alarm on (the replica recovered, but something crashed).
        self.engine_restarts = Counter(
            f"{prefix}_engine_restarts_total",
            "Engine crash recoveries (the supervisor rebuilt the "
            "batcher in place)",
            registry=registry,
        )
        self.engine_replayed_requests = Counter(
            f"{prefix}_engine_replayed_requests_total",
            "Queued (not yet decoding) requests re-admitted across "
            "engine restarts",
            registry=registry,
        )
        self.engine_resumed_requests = Counter(
            f"{prefix}_engine_resumed_requests_total",
            "Mid-stream requests resumed bit-identically across "
            "engine restarts",
            registry=registry,
        )
        # Multi-LoRA adapter residency (models/lora_serving.AdapterStore)
        # and the gathered O(active) compute path: registered vs HBM-
        # resident counts, upload latency, and the admission deferrals
        # an adapter miss or K-overflow causes (the adapter analogue of
        # kv_admission_rejected).
        self.adapters_registered = Gauge(
            f"{prefix}_adapters_registered",
            "LoRA adapters registered host-side (tombstones excluded)",
            registry=registry,
        )
        self.adapters_resident = Gauge(
            f"{prefix}_adapters_resident",
            "LoRA adapters currently resident in device HBM",
            registry=registry,
        )
        self.adapter_resident_bytes = Gauge(
            f"{prefix}_adapter_resident_bytes",
            "Device bytes held by HBM-resident LoRA adapter stacks",
            registry=registry,
        )
        self.adapter_uploads = Counter(
            f"{prefix}_adapter_uploads_total",
            "Host-to-device LoRA adapter block uploads",
            registry=registry,
        )
        self.adapter_upload_seconds = Histogram(
            f"{prefix}_adapter_upload_seconds",
            "LoRA adapter H2D upload latency (seconds)",
            buckets=LATENCY_BUCKETS,
            registry=registry,
        )
        self.adapter_deferred = Counter(
            f"{prefix}_adapter_deferred_total",
            "Admissions deferred head-of-line on adapter residency",
            ["reason"],  # adapter_miss | adapter_slots
            registry=registry,
        )
        self.adapter_gathers = Counter(
            f"{prefix}_adapter_gathers_total",
            "Compact-stack regathers (batch active-adapter set changed)",
            registry=registry,
        )
        self._win_t0 = time.monotonic()
        self._win_tokens = 0

    def close(self) -> None:
        """Unregister this instance's collectors so a replacement can
        register the same names on the same registry."""
        for c in (
            self.tokens_total,
            self.requests_submitted,
            self.requests_finished,
            self.prefill_chunks,
            self.prefill_tokens,
            self.prefix_hits,
            self.prefix_misses,
            self.prefix_evictions,
            self.prefix_tokens_saved,
            self.prefix_resident_bytes,
            self.prefix_entries,
            self.kv_pages_total,
            self.kv_pages_in_use,
            self.kv_page_fragmentation_pct,
            self.kv_admission_rejected,
            self.kv_pages_recycled,
            self.prefill_chunks_deferred,
            self.kv_reserved_bytes,
            self.kv_shard_reserved_bytes,
            self.kv_shard_pages_in_use,
            self.kv_shard_in_use_bytes,
            self.kv_shard_chip,
            self.decode_attn_backend,
            self.spec_rounds,
            self.spec_tokens_drafted,
            self.spec_tokens_accepted,
            self.spec_accepted_per_round,
            self.sched_queue_wait_seconds,
            self.sched_deadline_misses,
            self.sched_deadline_overrun_seconds,
            self.sched_goodput_tokens,
            self.sched_preemptions,
            self.sched_rejected,
            self.queue_depth,
            self.slots_active,
            self.slots_prefilling,
            self.tokens_per_second,
            self.ttft_seconds,
            self.inter_token_seconds,
            self.request_phase_seconds,
            self.serving_mfu,
            self.hbm_bw_util,
            self.model_flops,
            self.hbm_bytes,
            self.tenant_flops,
            self.decode_dispatch_seconds,
            self.decode_readback_seconds,
            self.pipeline_flushes,
            self.engine_restarts,
            self.engine_replayed_requests,
            self.engine_resumed_requests,
            self.adapters_registered,
            self.adapters_resident,
            self.adapter_resident_bytes,
            self.adapter_uploads,
            self.adapter_upload_seconds,
            self.adapter_deferred,
            self.adapter_gathers,
        ):
            try:
                self._registry.unregister(c)
            except KeyError:
                pass  # already unregistered

    # --- batcher hooks ---

    def on_submit(self) -> None:
        self.requests_submitted.inc()

    def on_prefill_chunk(self) -> None:
        self.prefill_chunks.inc()

    def on_prefill_tokens(self, n: int, source: str) -> None:
        """``source`` is "computed" (ran through the model) or
        "prefix_reused" (copied from cached prefix rows)."""
        self.prefill_tokens.labels(source=source).inc(n)

    # --- prefix-cache hooks (serving/prefix_cache.py) ---

    def on_prefix_hit(self, tokens_reused: int) -> None:
        self.prefix_hits.inc()
        self.prefix_tokens_saved.inc(tokens_reused)

    def on_prefix_miss(self) -> None:
        self.prefix_misses.inc()

    def on_prefix_evict(self, freed_bytes: int) -> None:
        self.prefix_evictions.inc()

    def set_prefix_resident_bytes(self, nbytes: int, entries: int) -> None:
        self.prefix_resident_bytes.set(nbytes)
        self.prefix_entries.set(entries)

    # --- paged-KV hooks (models/batching.py kv_stats/_report_kv_gauges) ---

    def set_kv_pages(self, total: int, in_use: int, frag_pct: float) -> None:
        self.kv_pages_total.set(total)
        self.kv_pages_in_use.set(in_use)
        self.kv_page_fragmentation_pct.set(frag_pct)

    def on_kv_admission_rejected(self, reason: str) -> None:
        self.kv_admission_rejected.labels(reason=reason).inc()

    def on_kv_pages_recycled(self, n: int) -> None:
        self.kv_pages_recycled.inc(n)

    def on_prefill_chunk_deferred(self, reason: str) -> None:
        self.prefill_chunks_deferred.labels(reason=reason).inc()

    def set_kv_reserved_bytes(self, nbytes: int) -> None:
        self.kv_reserved_bytes.set(nbytes)

    def set_decode_attn_backend(self, plan: dict) -> None:
        """Set the per-mode backend gauge from the batcher's startup
        plan ({mode: {"backend": ..., "reason": ...}}); both backends
        are written per mode (1 for the active one, 0 for the other) so
        a backend FLIP is a visible 1->0 transition, not a vanished
        series."""
        for mode, d in plan.items():
            active = d.get("backend", "plain")
            for backend in ("cuda", "plain"):
                self.decode_attn_backend.labels(mode, backend).set(
                    1 if backend == active else 0
                )

    # --- scheduler hooks (serving/scheduler.py) ---

    def observe_queue_wait(self, seconds: float) -> None:
        self.sched_queue_wait_seconds.observe(seconds)

    def on_deadline_miss(self, tenant: str, overrun_seconds: float) -> None:
        self.sched_deadline_misses.labels(tenant=tenant).inc()
        self.sched_deadline_overrun_seconds.observe(overrun_seconds)

    def on_goodput(self, tenant: str, priority: str, tokens: int) -> None:
        self.sched_goodput_tokens.labels(
            tenant=tenant, priority=priority
        ).inc(tokens)

    def on_preemption(self) -> None:
        self.sched_preemptions.inc()

    def on_sched_rejected(self, reason: str) -> None:
        self.sched_rejected.labels(reason=reason).inc()

    # --- speculative-decoding hook (models/spec_batching.py) ---

    def on_spec_round(self, gamma: int, accepted_counts) -> None:
        """One verify round: ``accepted_counts`` holds each active
        slot's device-side acceptance (1..gamma, bonus included)."""
        self.spec_rounds.inc()
        self.spec_tokens_drafted.inc(gamma * len(accepted_counts))
        self.spec_tokens_accepted.inc(sum(accepted_counts))
        for c in accepted_counts:
            self.spec_accepted_per_round.observe(c)

    def on_first_token(self) -> None:
        """The first generated token is sampled at prefill time, outside
        any decode step — counted here so tokens_total is complete."""
        self.tokens_total.inc()
        self._win_tokens += 1

    def on_step(self, emitted: int, queue: int, active: int, prefilling: int):
        """Called once per batcher step with host-side counts."""
        self.tokens_total.inc(emitted)
        self.queue_depth.set(queue)
        self.slots_active.set(active)
        self.slots_prefilling.set(prefilling)
        self._win_tokens += emitted
        dt = time.monotonic() - self._win_t0
        if dt >= 1.0:  # 1s sliding window keeps the gauge responsive
            self.tokens_per_second.set(self._win_tokens / dt)
            self._win_t0 = time.monotonic()
            self._win_tokens = 0

    def on_idle(self) -> None:
        """No traffic: zero the throughput gauge instead of freezing it
        at the last busy window's value, and restart the window."""
        self.tokens_per_second.set(0.0)
        self._win_t0 = time.monotonic()
        self._win_tokens = 0

    def on_finish(self, reason: str) -> None:
        self.requests_finished.labels(reason=reason).inc()

    @staticmethod
    def _exemplar(exemplar_id) -> "dict | None":
        """Trace-correlation exemplar for a latency bucket: rendered by
        the OpenMetrics exposition (`/metrics` with an openmetrics
        Accept header), ignored by the classic text format. The id is
        the request's trace_id under --tracing, else its "rid:N" stand-
        in — either way the bucket names a concrete example request."""
        if not exemplar_id:
            return None
        return {"trace_id": str(exemplar_id)[:64]}

    def observe_ttft(self, seconds: float, exemplar_id=None) -> None:
        self.ttft_seconds.observe(seconds, self._exemplar(exemplar_id))

    def observe_inter_token(self, seconds: float, exemplar_id=None) -> None:
        self.inter_token_seconds.observe(
            seconds, self._exemplar(exemplar_id)
        )

    # --- attribution hooks (obs/attribution.py) ---

    def observe_phase(self, phase: str, seconds: float,
                      exemplar_id=None) -> None:
        """One retired request's wall time in one lifecycle phase."""
        self.request_phase_seconds.labels(phase=phase).observe(
            seconds, self._exemplar(exemplar_id)
        )

    # --- MFU/roofline hooks (metrics/roofline.py MfuAccumulator) ---

    def set_mfu(self, mfu_pct: float, bw_pct: float) -> None:
        self.serving_mfu.set(mfu_pct)
        self.hbm_bw_util.set(bw_pct)

    def on_model_work(self, flops: float, nbytes: float) -> None:
        self.model_flops.inc(flops)
        self.hbm_bytes.inc(nbytes)

    def on_tenant_flops(self, tenant: str, flops: float) -> None:
        self.tenant_flops.labels(tenant=tenant).inc(flops)

    def observe_dispatch(self, seconds: float) -> None:
        self.decode_dispatch_seconds.observe(seconds)

    def observe_readback(self, seconds: float) -> None:
        self.decode_readback_seconds.observe(seconds)

    def on_engine_restart(self, replayed: int, resumed: int) -> None:
        self.engine_restarts.inc()
        if replayed:
            self.engine_replayed_requests.inc(replayed)
        if resumed:
            self.engine_resumed_requests.inc(resumed)

    def on_pipeline_flush(self) -> None:
        self.pipeline_flushes.inc()
