"""Inference HTTP server: the continuous batcher as a service.

Port of ``k8s_gpu_device_plugin_tpu/serving/server.py`` (engine,
``POST /v1/generate`` with SSE streaming, ``GET /v1/health``,
``load_params`` and the CLI), on the standard library's
``http.server`` instead of aiohttp. One engine thread owns the batcher
and drives its step loop; HTTP handler threads submit requests through a
locked queue and read per-request token queues.

Wire contract (the reference's):

- ``POST /v1/generate`` ``{"prompt": [ids...], "max_new": N, "stream":
  false, "logprobs": false, "stop": [[ids...], ...], "temperature",
  "top_k", "top_p", "repetition_penalty", "seed", "logit_bias":
  {"token_id": bias, ...}, "tenant", "priority" (0-9, lower = more
  urgent), "deadline_ms", "resume_out": [ids...], "resume_logprobs":
  [...], "kv_pages": {blob}}`` ->
  ``{"id", "tokens", "cached_tokens"[, "logprobs"]}``, or with
  ``"stream": true`` a ``text/event-stream`` of ``data: {"token": t[,
  "logprob": lp]}`` frames closing with ``data: {"done": true}``.
  ``cached_tokens`` counts the prompt tokens the prefix cache served
  (the prefill work a hit skipped; 0 on a miss); the SSE done event
  carries it only when it is > 0, as the reference's does.
  ``resume_out`` continues a stream another replica started: the
  tokens fold into the prompt and the answer carries only the
  continuation. With ``kv_pages`` (the blob ``POST /v1/kv/export``
  answered on that replica, ``models/paging.py``'s wire format, a paged
  pool of the same page size and quantization) its pages are installed
  instead of re-prefilled, and the continuation is the uninterrupted
  stream bit for bit; a pool that cannot hold them right now answers 429
  with ``reason`` ``kv_pool_pressure`` and ``Retry-After: 1``. ``"n"``
  (1 ... 8, not with ``stream``) decodes n independent choices in
  parallel slots, choice i seeded ``(seed + i) % 2**31``: the answer
  adds ``completions`` (and ``completions_logprobs``),
  and ``cached_tokens`` is the largest of the choices'. With a tokenizer
  (``--tokenizer``, ``serving/tokenizer.py``) ``"text"`` may replace
  ``"prompt"`` (not with ``resume_out``), ``"stop_text"`` adds encoded
  stop strings, and the answer and the SSE done event carry the decoded
  ``"text"`` (a resumed request's covers the whole output; n > 1 adds
  ``completions_text``). ``"timeline": true`` adds the request's latency
  timeline (``obs/attribution.py``: queue wait, prefill and decode
  segments summing to its wall time; null with ``--attributionOff``) to
  the answer and to the SSE done event. ``"adapter": "name"`` serves the
  request through that LoRA adapter (an unknown name answers 400). An
  unknown field answers 400 naming it, as does a ``logit_bias`` that is
  not an object of integer keys and numbers, a ``kv_pages`` that is not
  an object or comes without ``resume_out``, or a malformed scheduling
  or resume field; a request no slot can hold, a bias outside the
  batcher's bounds, a ``kv_pages`` blob that is malformed or does not
  fit the pool, or (with ``--chunkedPrefill 0``) a prompt longer than
  the largest bucket answers 422. A full queue (``--maxQueue``), or a
  request whose pool-pressure wait outlived ``--deferBudgetMs``, answers
  429 with a ``Retry-After`` header; a stream the engine could not
  finish ends with an ``{"error": {"code", "message"}}`` event (503 when
  not streamed).
- ``POST /v1/kv/export/{id}`` (a ``/v1/generate`` stream's
  ``X-Request-Id``) -> ``{"id", "kv_pages", "resume_out",
  "resume_logprobs"}``: the request's valid cache pages and the tokens
  it emitted, to resubmit elsewhere; the request retires (its stream
  closes with the tokens delivered so far, a prefix of ``resume_out``).
  400 for a malformed id, 404 for an unknown or finished request, 409
  while it is queued or prefilling, 503 for the dense layout, a dead
  engine or a timeout. Bodies are read whole: a Llama-3-8B bf16 blob of
  1536 rows is about 280 MB of JSON.
- ``GET /v1/health`` -> slots, active, prefilling, queued, alive, the
  prefix cache's counters (``prefix_cache``, the reference's keys, when
  the cache is on), the attention backend plan (``decode_attn``), the KV
  residency (``kv``: layout, reserved bytes, the window and, paged, the
  pool's occupancy, fragmentation, pages recycled out of the window and
  aliased by prefix hits, and the admissions it refused or made to
  wait; under ``--tp`` > 1 also ``tp`` and ``shards``, each shard's
  bytes and pages), prefill tokens computed and reused, the weights
  (``weights``: their quantization and resident bytes, and under
  ``--tp`` > 1 ``shard_bytes``, what the shards hold beyond the whole
  tree), the device,
  decode-step and prefill counts, how the decode step runs (``decode``:
  the pipeline depth and flushes, and on a card the captured CUDA
  graph's pool bytes, replays and launches a replay makes), the
  kernels' launch counts, the scheduler's snapshot (``sched``) and the
  supervisor's (``supervisor``: state, restart budget, crashes,
  restarts, requests replayed and resumed), the live roofline (``mfu``:
  the card's peaks, the last busy second's MFU and bandwidth share,
  per-tenant goodput per TFLOP) and the attribution counters
  (``attribution``), both absent with ``--attributionOff``, and with
  adapters served their residency (``adapters``: mode, registered and
  resident adapters and bytes, uploads and their p99, evictions,
  misses, gathers, slot copies, deferrals by reason); and the fleet
  identity the replica router (``serving/router.py``) keys on:
  ``replica_id`` (``--replicaId``, or hostname:port) and ``uptime_s``
  (its reset tells a new process behind the same address).
- Observability: ``GET /metrics`` (the classic Prometheus text, or
  OpenMetrics with trace-id exemplars when the client's ``Accept`` asks
  for ``application/openmetrics-text``; the families of
  ``metrics/serving_metrics.py`` on the server's own registry),
  ``GET /debug/traces?limit=&since=`` (the trace ring's summaries; a
  malformed query answers 400), ``GET /debug/traces/{trace_id}`` (one
  trace as Perfetto JSON), ``GET /debug/requests`` and
  ``/debug/requests/{rid}`` (recent timelines) and ``GET /debug/slow``
  (the flight recorder; all three 404 with ``--attributionOff``).
  ``--tracing`` turns the span trees on: each request gets a
  ``serving_http`` span that joins a caller's ``traceparent`` and
  answers one, the batcher's request tree under it; ``--traceSteps``
  adds a span per decode dispatch and readback. Attribution and the
  roofline are on by default, tracing is off, as in the reference.
- The OpenAI façade (``serving/openai_api.py``) on the same engine:
  ``POST /v1/completions``, ``POST /v1/chat/completions``, ``GET
  /v1/models`` and ``POST /v1/embeddings`` (``--embeddings``); echo
  prompt scoring on ``/v1/completions`` with ``--scoring``.

Routes are a table (``_GET_ROUTES``, ``_POST_ROUTES``; a trailing
``{name}`` segment matches one path segment) on one ``http.server``
handler. ``--eosId`` has the reference's three states:
unset adopts the tokenizer's EOS (none without one), ``none`` or -1
turns EOS stopping off, an id stops on that id.

Run: ``python -m k8s_gpu_device_plugin_torch.serving.server --preset
llama3_8b --port 8731`` (random weights drawn on the card from
``--seed``; ``--device cpu`` serves on the CPU). ``--kvLayout paged
--kvPageSize 64 --kvPages N`` serves from a pool of N pages (the trap
page included; 0 sizes it to the dense reservation); ``--cacheQuant
int8`` (or ``int4``) keeps K/V as int8 (int4) codes with f32 scales, on
either layout; ``--weightQuant int8|int4`` quantizes the projection,
MLP and lm_head weights after they load (weight-only, as the reference's
server does). ``--preset mixtral_8x7b`` serves Mixtral-8x7B (MoE, 8
experts, top 2): its bf16 weights (93.4 GB) do not fit one card, so it
is served with ``--weightQuant int8`` (about 46.9 GB) or ``int4``, its
expert stacks quantized one layer at a time as they are drawn.
``--pipelineDepth 1`` (the default) dispatches each decode
step before the previous one is read back, 0 runs the synchronous loop;
``--chunkedPrefill 0`` prefills each prompt whole at admission, padded to
its bucket, instead of in chunks of 256.

Automatic prefix caching (``serving/prefix_cache.py``) is on whenever
``--chunkedPrefill > 0``, as in the reference: a radix tree over token
ids at the prompt-bucket boundaries (32 ... 1024, cut at ``--maxLen``),
LRU-evicted under ``--prefixCacheMB`` (256) of device memory, promotion
after ``--prefixCacheMinHits`` (1) sightings, off with
``--prefixCacheOff``; streams are the same bit for bit either way.
``--attnWindow W`` serves the preset with a sliding window of W (0 keeps
the preset's own: ``mistral_7b`` has 4096); with ``--kvLayout paged``
and chunked prefill a windowed request reserves pages for its first
``--prefillReserveChunks`` (2) chunks, grows chunk by chunk, and gives
back the pages that leave its window, so a prompt far longer than the
pool's worst-case wall is served.

Scheduling and failure: ``--schedPolicy slo`` orders the queue by
priority class, tenant fairness (``--tenantQuota``) and deadline, and
preempts a lower-class decode for a request about to miss its deadline
(the victim resumes by re-prefill, token for token); ``--maxQueue`` and
``--deferBudgetMs`` bound the wait. The engine recovers a crash on its
thread in place (``--restartBudget`` per ``--restartWindowS``): a fresh
batcher, the queue replayed, every stream resumed. ``--faults`` arms the
seeded fault plane (``serving/faults.py``) that rehearses it.

Multi-LoRA (``models/lora_serving.py``): ``build_server(args,
adapters=...)`` serves an ``AdapterSet`` (made an ``AdapterStore`` under
``--adapterCacheMB`` of device memory, 0 = every adapter resident) or an
``AdapterStore`` from the caller; requests name an adapter by the
``adapter`` field or the OpenAI ``model`` field, and ``/v1/models``
lists them. The store outlives a crashed batcher, so adapters registered
at run time survive a restart. ``--adapterQuota name=rate[:burst=B]``
rate-limits adapters under every policy (429 with Retry-After).
``--loraAdapters name=ckptdir[:alpha=X],...`` serves adapters that the
port's LoRA training saved (``models/checkpoint.py``; the factors under
``"lora"`` or at the tree's root, rank and targets read off them).

Weights: ``--checkpointDir`` serves the latest step's ``params`` of a
training checkpoint (the trainer's ``--checkpointDir``; only the
``params`` file is read), ``--draftCheckpointDir`` the draft's; without
one the weights are drawn at random from ``--seed`` (smoke mode). A
checkpoint's depth is its own (the leading dimension of its layer
stacks: a run trained at a cut depth serves at that depth); its widths
must be the preset's.

Speculative decoding (``models/spec_batching.py``): ``--draftPreset P``
serves through a ``SpeculativeBatcher`` whose draft model is preset P,
its weights drawn as the target's are (``--seed``, then ``--weightQuant``;
a draft of the target's own preset is the target's tensors, shared, not
copied), verifying ``--gamma`` (4) proposals a round. It composes with
the layout (``--kvLayout paged`` pages both caches; ``--draftKvPages``
sizes the draft's pool, 0 = its dense-equivalent size, and needs both
``--draftPreset`` and ``--kvLayout paged``), the prefix cache and
``--pipelineDepth``. A per-request sampler, ``logit_bias`` or ``seed``
then answers 422, and ``/v1/health`` gains ``spec`` (gamma, rounds,
tokens drafted and accepted, acceptance rate, accepted per round) and
the draft's fields in ``kv``.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import json
import os
import queue
import socket
import statistics
import sys
import threading
import time
from dataclasses import replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import torch

from k8s_gpu_device_plugin_torch.device import resolve_device
from k8s_gpu_device_plugin_torch.metrics.exposition import (
    CONTENT_TYPE_CLASSIC,
    CONTENT_TYPE_OPENMETRICS,
    OPENMETRICS_ACCEPT,
    Registry,
)
from k8s_gpu_device_plugin_torch.metrics.roofline import (
    MfuAccumulator,
    ServingCostModel,
)
from k8s_gpu_device_plugin_torch.metrics.serving_metrics import ServingMetrics
from k8s_gpu_device_plugin_torch.models.batching import (
    DEFAULT_PROMPT_BUCKETS,
    ContinuousBatcher,
    RequestTooLargeError,
)
from k8s_gpu_device_plugin_torch.models.checkpoint import TrainCheckpointer
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig, init_params
from k8s_gpu_device_plugin_torch.models.lora import LoraConfig, target_dims
from k8s_gpu_device_plugin_torch.models.lora_serving import (
    AdapterSet,
    AdapterStore,
    stack_adapters,
)
from k8s_gpu_device_plugin_torch.models.moe import EXPERT_LEAVES, store_layer
from k8s_gpu_device_plugin_torch.models.paging import (
    kv_wire_planes,
    pack_kv_wire,
)
from k8s_gpu_device_plugin_torch.models.quantized_serving import (
    WEIGHT_QUANTS,
    expert_quantizer,
    quantize_weights,
    weight_quant_of,
)
from k8s_gpu_device_plugin_torch.models.sampling import Sampler
from k8s_gpu_device_plugin_torch.models.spec_batching import SpeculativeBatcher
from k8s_gpu_device_plugin_torch.obs.attribution import RequestAttributor
from k8s_gpu_device_plugin_torch.obs.http import (
    is_observation_path,
    parse_trace_query,
    route_label,
    trace_detail_payload,
    traces_payload,
)
from k8s_gpu_device_plugin_torch.obs.prom import SpanMetrics
from k8s_gpu_device_plugin_torch.obs.trace import (
    TRACEPARENT_HEADER,
    attach,
    configure,
    current_context,
    format_traceparent,
    get_tracer,
    parse_traceparent,
)
from k8s_gpu_device_plugin_torch.ops.kernel_support import launch_counts
from k8s_gpu_device_plugin_torch.parallel.mesh import MeshSpec
from k8s_gpu_device_plugin_torch.parallel.tp_serving import EXACT_CUBLAS_ENV
from k8s_gpu_device_plugin_torch.serving.embeddings import Embedder
from k8s_gpu_device_plugin_torch.serving.faults import FaultError, FaultPlane
from k8s_gpu_device_plugin_torch.serving.prefix_cache import PrefixCache
from k8s_gpu_device_plugin_torch.serving.scheduler import (
    SchedulerOverloadError,
    make_scheduler,
)
from k8s_gpu_device_plugin_torch.serving.scoring import Scorer
from k8s_gpu_device_plugin_torch.serving.supervisor import (
    EngineSupervisor,
    StreamError,
)
from k8s_gpu_device_plugin_torch.serving.tokenizer import (
    encode_stop_strings,
    load_tokenizer,
)
from k8s_gpu_device_plugin_torch.utils.log import get_logger

log = get_logger()

PRESETS = {
    "tiny": LlamaConfig.tiny,
    "llama3_8b": LlamaConfig.llama3_8b,
    "llama3_70b": LlamaConfig.llama3_70b,
    "mistral_7b": LlamaConfig.mistral_7b,
    "mixtral_8x7b": LlamaConfig.mixtral_8x7b,
}

_KNOBS = {"temperature": float, "top_k": int, "top_p": float,
          "repetition_penalty": float}
_FIELDS = {"prompt", "text", "max_new", "stream", "logprobs", "stop",
           "stop_text", "seed", "n", "logit_bias", "tenant", "priority",
           "deadline_ms", "resume_out", "resume_logprobs", "kv_pages",
           "timeline", "adapter", *_KNOBS}
#: choices one request may ask for (each holds a decode slot)
MAX_N = 8


class InferenceEngine:
    """Background thread around a ContinuousBatcher (or a subclass: the
    ``SpeculativeBatcher``) with per-request token queues. ``submit`` is
    thread-safe; each queue receives ``(token, logprob)`` pairs, then
    ``None`` at end of stream (preceded by a :class:`StreamError` if the
    engine could not finish it).

    ``make_batcher`` is the batcher's recipe (a factory): with it, an
    exception on the engine thread is recovered in place by the
    ``supervisor`` (default: 3 restarts in a rolling 300 s), which builds
    a fresh batcher and resumes every stream; past its budget, or without
    a recipe, the engine dies and every open stream ends with a
    structured ``engine_dead`` frame. ``batcher`` may be omitted when the
    recipe is given. ``default_deadline_ms`` (0 = none) applies to
    requests that name no deadline. ``tp`` (None = the batcher's) is
    checked against the batcher the recipe builds; with a batcher passed
    in, a tp > 1 is refused: it belongs to that batcher's constructor."""

    def __init__(self, batcher: "ContinuousBatcher | None" = None, *,
                 make_batcher=None,
                 supervisor: "EngineSupervisor | None" = None,
                 default_deadline_ms: int = 0,
                 tp: "int | None" = None):
        if batcher is None and make_batcher is None:
            raise ValueError("InferenceEngine needs a batcher or its recipe")
        if batcher is not None and tp not in (None, 1):
            raise ValueError(
                "pass tp to the injected batcher's own constructor; "
                "silently ignoring it here would serve single-chip "
                "while reporting a sharded mesh")
        if make_batcher is None and supervisor is not None:
            raise ValueError(
                "crash recovery needs the batcher's recipe (make_batcher): "
                "a batcher passed alone cannot be rebuilt")
        self.cb = batcher if batcher is not None else make_batcher()
        if tp is not None and self.cb.cfg.tp != tp:
            raise ValueError(
                f"the batcher recipe built a tp={self.cb.cfg.tp} batcher, "
                f"not tp={tp}")
        self._make_batcher = make_batcher
        self.supervisor = (None if make_batcher is None else
                           supervisor or EngineSupervisor())
        self._default_deadline_ms = int(default_deadline_ms)
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._dead = threading.Event()
        self._subq: list[tuple] = []     # owner: request threads -> engine
        self._cancelq: list[int] = []
        # KV page exports: (eid, future), drained each pass of the loop
        self._exportq: list[tuple] = []
        self._streams: dict[int, queue.Queue] = {}  # eid -> token queue
        self._published: dict[int, int] = {}        # eid -> tokens pushed
        self._rid_to_eid: dict[int, int] = {}       # owner: engine thread
        # eid -> what a finished request's handler answers besides its
        # tokens (cached_tokens, a rejection), recorded before its stream
        # closes
        self._finished_info: dict[int, dict] = {}
        self._next_eid = 0
        # time to first token of recently finished requests (seconds)
        self._ttft_s: collections.deque = collections.deque(maxlen=4096)
        self._thread = threading.Thread(target=self._loop,
                                        name="torch-inference-engine",
                                        daemon=True)
        self._thread.start()

    # --- request side (any thread) ---

    def submit(self, prompt: list[int], max_new: int,
               stop: "list[list[int]] | None" = None,
               sampler: "Sampler | None" = None,
               seed: "int | None" = None,
               logit_bias=None,
               tenant: "str | None" = None,
               priority: "int | None" = None,
               deadline_ms: "int | None" = None,
               resume_out: "list[int] | None" = None,
               resume_logp: "list[float] | None" = None,
               adapter: int = -1,
               kv_pages=None,
               ) -> tuple[int, queue.Queue]:
        """Validate (everything the batcher would) and queue a request.
        Returns (engine id, its token queue). Raises the scheduler's
        overload error (HTTP 429) when its queue is full.

        ``resume_out``/``resume_logp`` continue a stream another
        incarnation started: the tokens fold into the prompt, and since
        the client has them already, the stream carries only the
        continuation. ``kv_pages`` (a wire blob another replica's
        :meth:`export_kv` made) upgrades the resume to a page install:
        it is decoded and staged here, on the request thread, so the
        engine thread only copies it to the card. A pool without the
        pages free right now raises the overload error (429
        ``kv_pool_pressure``) rather than parking a live stream behind
        it; the engine thread's reservation still defers if a burst
        races past this approximate check."""
        if self._dead.is_set():
            raise RuntimeError("inference engine is dead (see logs)")
        cb = self.cb
        resume_out, resume_logp = cb.validate_resume(resume_out, resume_logp,
                                                     max_new)
        prompt = cb.validate_prompt(prompt)
        # the batcher's own rule over the folded prompt and the budget left
        cb.validate(len(prompt) + len(resume_out), max_new - len(resume_out))
        kv_wire = cb.validate_kv_pages(kv_pages, len(prompt),
                                       len(resume_out))
        if kv_wire is not None:
            need, free = cb.kv_install_headroom(
                len(prompt) + len(resume_out), max_new - len(resume_out))
            if need > free:
                raise SchedulerOverloadError(
                    f"KV transfer needs {need} pages, {free} free: the "
                    "install would wait behind pool pressure; re-prefill "
                    "elsewhere or retry", reason="kv_pool_pressure",
                    retry_after=1)
        if sampler is not None and not cb.per_request_sampler:
            raise ValueError(
                "per-request sampling is not supported by this engine "
                "(speculative batching shares one sampler)"
            )
        if logit_bias and not cb.per_request_bias:
            raise ValueError(
                "logit_bias is not supported by this engine "
                "(speculative batching threads no bias planes)"
            )
        cb.validate_adapter(adapter)
        bias = cb.validate_bias(logit_bias)
        seed = cb.validate_seed(seed)
        if seed is not None and not cb.per_request_seed:
            raise ValueError(
                "per-request seeds are not supported by this engine"
            )
        if deadline_ms is None and self._default_deadline_ms:
            deadline_ms = self._default_deadline_ms
        tenant, priority, deadline_ms = cb.validate_sched(
            tenant, priority, deadline_ms)
        sched = cb.scheduler
        if sched is not None:
            # the queue cap on the request thread, so overload answers 429
            # at once; the engine thread's check stays authoritative
            with self._lock:
                queued_local = len(self._subq)
            sched.check_capacity(len(cb.pending) + queued_local)
        # the thread hop: the batcher admits on the engine thread, where
        # this thread's context is invisible, so the active span (the
        # HTTP handler's) rides on the submission and is attached around
        # the batcher's submit there
        parent = current_context() if get_tracer().enabled else None
        q: queue.Queue = queue.Queue()
        with self._lock:
            # death re-checked under the lock: ``_die`` empties the
            # streams under it after setting ``_dead``
            if self._dead.is_set():
                raise RuntimeError("inference engine is dead (see logs)")
            eid = self._next_eid
            self._next_eid += 1
            self._subq.append((eid, prompt, max_new, stop, sampler, seed,
                               bias, tenant, priority, deadline_ms,
                               (resume_out, resume_logp, kv_wire), adapter,
                               parent))
            self._streams[eid] = q
            # the published cursor starts past the resumed tokens
            self._published[eid] = len(resume_out)
        self._work.set()
        return eid, q

    def cancel(self, eid: int) -> None:
        """Queue a cancellation (a client that went away frees its slot)."""
        with self._lock:
            self._cancelq.append(eid)
        self._work.set()

    def export_kv(self, eid: int, timeout: float = 30.0) -> dict:
        """Export a decoding request's KV pages and retire it: the body
        of ``POST /v1/kv/export/{rid}``, a resubmittable ``kv_pages``
        blob with its ``resume_out`` and ``resume_logprobs``. The engine
        thread reads the pages, cancels the request and publishes back
        to back (:meth:`_apply_exports`), so the stream cannot emit a
        token after the snapshot: it closes having delivered a prefix of
        ``resume_out``. The blob's base64 is encoded here, on the asking
        thread, off the engine's loop.

        Raises KeyError (unknown or finished), ValueError (queued,
        prefilling, or its early pages recycled), RuntimeError (the
        dense layout, a dead engine) or TimeoutError."""
        if self._dead.is_set():
            raise RuntimeError("inference engine is dead (see logs)")
        if self.cb.pool is None:
            raise RuntimeError(
                "KV page export requires the paged layout (--kvLayout "
                "paged); this replica serves dense KV")
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            self._exportq.append((eid, fut))
        self._work.set()
        try:
            planes, meta, out, lps = fut.result(timeout)
        except concurrent.futures.TimeoutError:
            raise TimeoutError(
                f"KV export of request {eid} timed out after {timeout} s"
            ) from None
        blob = pack_kv_wire(kv_wire_planes(planes, meta["cache_quant"]),
                            **meta)
        return {"kv_pages": blob, "resume_out": out,
                "resume_logprobs": lps}

    def pop_request_info(self, eid: int) -> dict:
        """A finished request's wrap-up facts (``cached_tokens``; a
        rejection's ``reject_reason`` and ``retry_after``), once; empty
        for an unknown id."""
        with self._lock:
            return self._finished_info.pop(eid, {})

    def stats(self) -> dict:
        with self._lock:
            queued_local = len(self._subq)
            ttft = list(self._ttft_s)
        cb = self.cb
        decode_s = cb.decode_s
        out = {
            "slots": cb.n_slots,
            "active": len(cb.running),
            "prefilling": len(cb.prefilling),
            "queued": len(cb.pending) + queued_local,
            "alive": not self._dead.is_set(),
        }
        if cb.prefix_cache is not None:
            out["prefix_cache"] = cb.prefix_cache.stats.as_dict()
        spec_stats = getattr(cb, "spec_stats", None)
        if spec_stats is not None:
            # speculative acceptance: the production view of gamma
            out["spec"] = spec_stats()
        adapters = cb.adapter_stats()
        if adapters is not None:
            # multi-LoRA residency: the store's snapshot (under its lock)
            # and the engine's gathers and deferrals
            out["adapters"] = adapters
        if cb.scheduler is not None:
            # queue and per-tenant SLO view, the scheduler's snapshot
            out["sched"] = cb.scheduler.sched_stats()
        if self.supervisor is not None:
            # crash recovery: state, budget, replay and resume tallies
            out["supervisor"] = self.supervisor.stats()
        mfu = cb.mfu_stats()
        if mfu is not None:
            # the live roofline: the card's peaks, the windowed MFU and
            # bandwidth shares, per-tenant goodput per TFLOP
            out["mfu"] = mfu
        attr = cb.attribution_stats()
        if attr is not None:
            # counts only: the timelines live on /debug/requests, /slow
            out["attribution"] = attr
        kv = {**cb.kv_stats(), "admission_rejected": cb.kv_rejections()}
        if cb.pool is not None:
            kv["prefill_chunks_deferred"] = cb.chunks_deferred
        return {
            **out,
            "device": str(cb.device),
            "decode_attn": cb.attn_plan,
            "kv": kv,
            "weights": dict(cb.weight_stats),
            "decode": cb.decode_stats(),
            "decode_steps": cb.decode_steps,
            "decode_tokens": cb.decode_tokens,
            "decode_step_ms_mean": (
                1e3 * decode_s / cb.decode_steps if cb.decode_steps else None
            ),
            "decode_tokens_per_s": (
                cb.decode_tokens / decode_s if decode_s else None
            ),
            "prefill_chunks": cb.prefill_chunks,
            "prefill_tokens": dict(cb.prefill_tokens),
            "prefill_chunk_ms_mean": (
                1e3 * cb.prefill_s / cb.prefill_chunks
                if cb.prefill_chunks else None
            ),
            "finished": len(ttft),
            "ttft_s_p50": statistics.median(ttft) if ttft else None,
            "kernel_launches": launch_counts(),
        }

    def shutdown(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self._work.set()
        self._thread.join(timeout)

    # --- engine thread ---

    def _admit_submissions(self) -> None:
        with self._lock:
            batch, self._subq = self._subq, []
        for (eid, prompt, max_new, stop, sampler, seed, bias, tenant,
             priority, deadline_ms, resume, adapter, parent) in batch:
            try:
                with attach(parent):  # the request tree joins the HTTP span
                    rid = self.cb.submit(
                        prompt, max_new, stop=stop, sampler=sampler,
                        seed=seed, logit_bias=bias, tenant=tenant,
                        priority=priority, deadline_ms=deadline_ms,
                        resume_out=resume[0], resume_logp=resume[1],
                        kv_pages=resume[2], adapter=adapter)
            except SchedulerOverloadError as e:
                # the request thread's queue-cap check raced a burst: the
                # stream closes with the rejection, its handler answers 429
                self.cb.scheduler.count_sync_rejection(self.cb)
                self._close_unadmitted(eid, {"reject_reason": e.reason,
                                             "retry_after": e.retry_after})
                continue
            except Exception as e:  # noqa: BLE001 - one bad admission
                # kills neither the loop nor the other streams
                log.exception("admission failed for eid=%s", eid)
                self._close_unadmitted(eid, None, StreamError(
                    "submit_failed", f"admission failed: {e}"))
                continue
            self._rid_to_eid[rid] = eid

    def _close_unadmitted(self, eid: int, info: "dict | None",
                          err: "StreamError | None" = None) -> None:
        with self._lock:
            q = self._streams.pop(eid, None)
            self._published.pop(eid, None)
            if info is not None:
                self._finished_info[eid] = info
        if q is not None:
            if err is not None:
                q.put(err)
            q.put(None)

    def _apply_cancellations(self) -> None:
        with self._lock:
            cancels, self._cancelq = self._cancelq, []
        for eid in cancels:
            rid = next((r for r, e in self._rid_to_eid.items() if e == eid),
                       None)
            if rid is not None:
                self.cb.cancel(rid)

    def _apply_exports(self) -> None:
        """Drain the queued KV exports: each reads its request's pages
        and emitted tokens (reading the step in flight first), cancels
        the request and publishes, in one pass of this thread. The API's
        refusals (KeyError, ValueError) go back to the asking thread; any
        other failure does too, as a RuntimeError, and is raised on to
        the crash boundary."""
        with self._lock:
            ops, self._exportq = self._exportq, []
        for i, (eid, fut) in enumerate(ops):
            try:
                res = self._export_one(eid)
            except (KeyError, ValueError) as e:
                fut.set_exception(e)
                continue
            except Exception as e:
                for _, f in ops[i:]:
                    f.set_exception(RuntimeError(f"KV export failed: {e}"))
                raise
            fut.set_result(res)

    def _export_one(self, eid: int) -> tuple:
        rid = next((r for r, e in self._rid_to_eid.items() if e == eid),
                   None)
        if rid is None:
            with self._lock:
                queued = any(sub[0] == eid for sub in self._subq)
            if queued:
                raise ValueError(
                    f"request {eid} has not been admitted yet: wait for its "
                    "first token before exporting")
            raise KeyError(f"unknown or finished request {eid}")
        res = self.cb.export_kv_planes(rid)
        self.cb.cancel(rid)
        self._publish()
        return res

    def _push(self, rid: int, out: list[int], logp: list[float]) -> None:
        eid = self._rid_to_eid.get(rid)
        if eid is None:
            return
        with self._lock:
            q = self._streams.get(eid)
            seen = self._published.get(eid, 0)
            self._published[eid] = len(out)
        if q is None:
            return
        for tok, lp in zip(out[seen:], logp[seen:]):
            q.put((int(tok), float(lp)))

    def _close_stream(self, rid: int, eid: int, req) -> None:
        """A retired request's wrap-up: record what its handler answers
        besides the tokens, then end its stream."""
        info = {"cached_tokens": req.cached_tokens}
        if req.timeline is not None and req.timeline.record is not None:
            # the finalized timeline (a plain dict built at retirement on
            # this thread): the handler exports it when asked
            info["timeline"] = req.timeline.record
        if req.reject_reason is not None:
            # rejected while queued (the deferral budget): a 429
            info["reject_reason"] = req.reject_reason
            sched = self.cb.scheduler
            info["retry_after"] = (sched.retry_after_s() if sched is not None
                                   else 1)
        with self._lock:
            q = self._streams.pop(eid, None)
            self._published.pop(eid, None)
            self._finished_info[eid] = info
            if len(self._finished_info) > 4096:
                # a handler that went away never pops its entry
                self._finished_info.pop(next(iter(self._finished_info)))
            if req.t_first_tok:
                self._ttft_s.append(req.t_first_tok - req.t_submit)
        del self._rid_to_eid[rid]
        if q is not None:
            q.put(None)

    def _publish(self) -> None:
        """Push new (token, logprob) pairs; close finished streams."""
        cb = self.cb
        for req in (list(cb.running.values()) + list(cb.prefilling.values())
                    + list(cb.pending)):
            self._push(req.rid, req.out, req.out_logp)
        for rid, eid in list(self._rid_to_eid.items()):
            req = cb.done_requests.pop(rid, None)
            if req is None:
                continue
            self._push(rid, req.out, req.out_logp)
            cb.done.pop(rid, None)
            self._close_stream(rid, eid, req)

    def _loop(self) -> None:
        """The crash boundary around the step loop: an exception on the
        engine thread is recovered in place by the supervisor (a fresh
        batcher, queued work replayed in order, streams in flight
        resumed by the preemption fold) while the restart budget lasts;
        past it, or without a recipe, the engine dies and every stream
        ends with a structured error frame."""
        while True:
            try:
                self._loop_inner()
                return  # shutdown
            except Exception as exc:  # noqa: BLE001 - the crash boundary
                log.exception("inference engine loop died")
                if self._stop.is_set():
                    return  # a crash racing shutdown: the clean exit
                error = f"{type(exc).__name__}: {exc}"
                sup = self.supervisor
                if sup is not None:
                    sup.on_crash(exc)
                restart = sup is not None and sup.allow_restart()
            # out of the except clause: the exception and its traceback
            # (whose frames hold the crashed batcher) are gone, so the
            # recovery can free that batcher's device memory
            if not restart:
                detail = (" (restart budget exhausted)"
                          if sup is not None and sup.max_restarts else "")
                self._die("engine_dead",
                          f"inference engine died{detail}: {error}")
                return
            try:
                sup.recover(self)
            except Exception:  # noqa: BLE001 - the rebuild failed
                log.exception("engine recovery failed; degrading to dead")
                self._die("engine_dead",
                          "inference engine recovery failed (see logs)")
                return

    def _loop_inner(self) -> None:
        busy = False
        while not self._stop.is_set():
            self._admit_submissions()
            self._apply_cancellations()
            self._apply_exports()
            cb = self.cb
            if cb.pending or cb.running or cb.prefilling:
                cb.step()
                self._publish()
                busy = True
                continue
            self._publish()
            if busy:
                # busy -> idle: the throughput and MFU gauges read 0
                # while idle, not the last busy window's values
                busy = False
                if cb.metrics is not None:
                    cb.metrics.on_idle()
                if cb.mfu is not None:
                    cb.mfu.on_idle()
            self._work.wait(timeout=0.05)
            self._work.clear()

    def _die(self, code: str, message: str) -> None:
        """The dead state: every open stream gets a structured
        :class:`StreamError` frame, then its end."""
        if self.supervisor is not None:
            self.supervisor.mark_dead()
        self._dead.set()
        with self._lock:
            streams, self._streams = self._streams, {}
            self._published.clear()
        err = StreamError(code, message)
        for q in streams.values():
            q.put(err)
            q.put(None)


def _parse_logit_bias(raw) -> "dict | None":
    """The wire's logit_bias ({"token_id": bias}: string keys, as OpenAI
    sends them) -> {int: float}; the bounds are the batcher's
    ``validate_bias``."""
    if raw is None:
        return None
    if not isinstance(raw, dict):
        raise ValueError("logit_bias must be an object of token_id: bias")
    try:
        return {int(k): float(v) for k, v in raw.items()}
    except (TypeError, ValueError):
        raise ValueError(
            "logit_bias keys must be integer token ids and values numbers"
        ) from None


def _is_ids(x) -> bool:
    return isinstance(x, list) and bool(x) and all(
        isinstance(t, int) and not isinstance(t, bool) for t in x)


def _parse_request(body, tokenizer=None) -> dict:
    """The /v1/generate body -> submit kwargs (+ n, stream, logprobs and
    the resumed tokens). ``tokenizer`` serves ``text`` and ``stop_text``.
    Raises ValueError with a message naming the offending field."""
    if not isinstance(body, dict):
        raise ValueError("the request body must be a JSON object")
    for name in body:
        if name not in _FIELDS:
            raise ValueError(
                f"field {name!r} is not implemented by this server yet"
            )
    text = body.get("text")
    if text is not None:
        if tokenizer is None:
            raise ValueError("field 'text' needs a tokenizer: none is "
                             "configured on this server (--tokenizer); "
                             "send token ids via 'prompt'")
        if not isinstance(text, str) or not text:
            raise ValueError("text must be a non-empty string")
        if "prompt" in body:
            raise ValueError("send either 'text' or 'prompt', not both")
        prompt = tokenizer.encode(text)
    elif "prompt" not in body:
        raise ValueError("field 'prompt' (or 'text') is required")
    else:
        prompt = body["prompt"]
        if not _is_ids(prompt):
            raise ValueError("prompt must be a non-empty list of token ids")
    max_new = body.get("max_new", 64)
    if not isinstance(max_new, int) or isinstance(max_new, bool):
        raise ValueError("max_new must be an integer")
    n = body.get("n", 1)
    if not isinstance(n, int) or isinstance(n, bool) or not 1 <= n <= MAX_N:
        raise ValueError(f"n must be an integer in [1, {MAX_N}]")
    stream = bool(body.get("stream", False))
    if n > 1 and stream:
        raise ValueError("streaming supports n=1 only")
    stop = body.get("stop", [])
    if not isinstance(stop, list) or not all(_is_ids(st) for st in stop):
        raise ValueError("stop must be a list of token-id lists")
    if body.get("stop_text"):
        stop = list(stop) + encode_stop_strings(
            tokenizer, body["stop_text"], field="stop_text")
    given = {k: cast(body[k]) for k, cast in _KNOBS.items() if k in body}
    # validated BEFORE the per-choice (seed + i) % 2**31 derivation, which
    # would wrap an invalid seed into range
    seed = ContinuousBatcher.validate_seed(body.get("seed"))
    # the SLO identity: optional, defaulted at the engine, checked by the
    # batcher's rule
    sched = {k: body.get(k) for k in ("tenant", "priority", "deadline_ms")}
    ContinuousBatcher.validate_sched(**sched)
    # the resume seam: tokens another incarnation emitted and delivered
    resume_out = body.get("resume_out")
    resume_lp = body.get("resume_logprobs")
    if resume_out is not None:
        if not _is_ids(resume_out):
            raise ValueError(
                "resume_out must be a non-empty list of token ids")
        if text is not None:
            raise ValueError("resume_out requires a token-id 'prompt' (the "
                             "fold is defined over ids, not text)")
        if n != 1:
            raise ValueError("resume_out supports n=1 only")
    if resume_lp is not None and (
            not isinstance(resume_lp, list)
            or not all(isinstance(x, (int, float)) for x in resume_lp)):
        raise ValueError("resume_logprobs must be a list of numbers")
    # KV pages another replica exported ride the resume seam: the engine
    # installs them instead of re-prefilling the folded prompt
    kv_pages = body.get("kv_pages")
    if kv_pages is not None:
        if resume_out is None:
            raise ValueError(
                "kv_pages requires resume_out (the transferred pages cover "
                "the folded prompt's rows)")
        if not isinstance(kv_pages, dict):
            raise ValueError(
                "kv_pages must be a KV wire blob object (see "
                "/v1/kv/export)")
    timeline = body.get("timeline", False)
    if not isinstance(timeline, bool):
        raise ValueError("timeline must be a boolean")
    return {
        "prompt": prompt, "max_new": max_new, "stop": stop,
        "sampler": Sampler(**given) if given else None,
        "seed": seed,
        "logit_bias": _parse_logit_bias(body.get("logit_bias")),
        **sched, "resume_out": resume_out, "resume_logp": resume_lp,
        "kv_pages": kv_pages, "n": n, "stream": stream, "timeline": timeline,
        "logprobs": bool(body.get("logprobs", False)),
        # a name: the server resolves it against its live registry
        "adapter": body.get("adapter"),
    }


def kv_export_json(res: dict) -> bytes:
    """An export's answer (``InferenceEngine.export_kv``) as
    ``json.dumps(res).encode()`` gives it, byte for byte, with each
    plane's base64 payload spliced in rather than run through the
    encoder: base64 needs no escaping, and a Llama-3-8B blob carries
    hundreds of MB of it."""
    planes = res["kv_pages"]["planes"]
    skeleton = {**res, "kv_pages": {**res["kv_pages"], "planes": {
        name: {**p, "data": ""} for name, p in planes.items()}}}
    parts = json.dumps(skeleton).encode().split(b'"data": ""')
    if len(parts) != len(planes) + 1:
        raise ValueError("a KV export answer carries one payload a plane")
    out = [parts[0]]
    for p, rest in zip(planes.values(), parts[1:]):
        out += [b'"data": "', p["data"].encode("ascii"), b'"', rest]
    return b"".join(out)


def drain_queue(q: queue.Queue) -> tuple:
    """One request's (tokens, logprobs, error) off its stream queue
    (None ends it; a :class:`StreamError` before it marks an abnormal
    close). Shared by the native and OpenAI handlers, which answer an
    error with an error status, never a silent truncation."""
    toks: list[int] = []
    lps: list[float] = []
    err: "StreamError | None" = None
    while True:
        item = q.get()
        if item is None:
            return toks, lps, err
        if isinstance(item, StreamError):
            err = item
            continue
        toks.append(item[0])
        lps.append(item[1])


def submit_choices(engine: "InferenceEngine", prompt: list[int], n: int,
                   seed: "int | None", **kw) -> list[tuple]:
    """Submit ``n`` choices of one request: choice i is seeded ``(seed +
    i) % 2**31`` (reproducible and distinct: one seed for all would give
    n copies). A burst that fails part way cancels what it submitted."""
    subs: list[tuple] = []
    try:
        for i in range(n):
            subs.append(engine.submit(
                prompt, seed=None if seed is None else (seed + i) % 2**31,
                **kw))
    except Exception:
        for eid, _ in subs:
            engine.cancel(eid)
        raise
    return subs


def _match_route(table: dict, path: str) -> "tuple | None":
    """(template, (owner, method), the trailing parameter or None) of the
    route ``path`` takes: an exact path, or a template whose last segment
    is ``{name}`` and matches one segment."""
    name = table.get(path)
    if name is not None:
        return path, name, None
    head, _, tail = path.rpartition("/")
    if not tail:
        return None
    for template, name in table.items():
        if template.endswith("}") and template.rpartition("/")[0] == head:
            return template, name, tail
    return None


class _Handler(BaseHTTPRequestHandler):
    server: "InferenceServer"
    #: the matched route's template (the span label), its parameter and
    #: the query string
    route_template: "str | None" = None
    route_param: "str | None" = None
    query = ""
    #: the request's serving_http span while one is open (its
    #: traceparent goes out on the response), and the status sent
    _span = None
    _status = 0

    def log_message(self, fmt, *args) -> None:  # route access logs to debug
        log.debug("http: " + fmt, *args)

    def send_response(self, code: int, message: "str | None" = None) -> None:
        self._status = code
        super().send_response(code, message)
        if self._span is not None:
            self.send_header(TRACEPARENT_HEADER,
                             format_traceparent(self._span))

    def _send(self, status: int, data: bytes, content_type: str,
              headers: "dict | None" = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _json(self, status: int, payload: dict,
              headers: "dict | None" = None) -> None:
        self._send(status, json.dumps(payload).encode(), "application/json",
                   headers)

    def _overloaded(self, message: str, reason: str,
                    retry_after: int) -> None:
        """429 with a Retry-After header: back off and retry, as against
        a request that can never succeed."""
        self._json(429, {"error": message, "code": "overloaded",
                         "reason": reason, "retry_after": int(retry_after)},
                   headers={"Retry-After": str(int(retry_after))})

    def read_json(self):
        """The request body as JSON (JSONDecodeError on garbage)."""
        n = int(self.headers.get("Content-Length", "0"))
        return json.loads(self.rfile.read(n) or b"null")

    def start_sse(self, headers: "dict | None" = None) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()

    def sse(self, data: "dict | str") -> None:
        """One ``data:`` frame (a dict as JSON), flushed."""
        text = data if isinstance(data, str) else json.dumps(data)
        self.wfile.write(f"data: {text}\n\n".encode())
        self.wfile.flush()

    def _route(self, table: dict) -> None:
        path, _, self.query = self.path.partition("?")
        hit = _match_route(table, path)
        self.route_template, self.route_param = (
            (hit[0], hit[2]) if hit is not None else (None, None))
        tracer = get_tracer()
        remote = (parse_traceparent(self.headers.get(TRACEPARENT_HEADER))
                  if tracer.enabled else None)
        if not tracer.enabled or (remote is None
                                  and is_observation_path(path)):
            # telemetry reads may join a trace but never start one: a
            # root span per probe or scrape would evict the request
            # traces from the ring
            self._dispatch(hit)
            return
        # the route's template names the span (a bounded histogram
        # label); it is the ambient parent of everything the handler
        # does, the engine's submit included
        with tracer.span(f"{self.command} {route_label(self)}",
                         component="serving_http", parent=remote,
                         method=self.command, path=path,
                         replica=self.server.replica_label()) as span:
            self._span = span
            try:
                self._dispatch(hit)
            finally:
                self._span = None
                span.set(status_code=self._status)

    def _dispatch(self, hit: "tuple | None") -> None:
        if hit is None:
            self._json(404, {"error": f"no route {self.path}"})
            return
        owner, method = hit[1]
        if owner == "native":
            getattr(self, method)()
            return
        # imported here: openai_api imports this module. One routes object
        # a request: a server holding one would be a reference cycle, and
        # a stopped server (its cache) would wait for the cycle collector
        from k8s_gpu_device_plugin_torch.serving.openai_api import (
            OpenAIRoutes,
        )

        getattr(OpenAIRoutes(self.server), method)(self)

    def do_GET(self) -> None:  # noqa: N802 - http.server's naming
        self._route(_GET_ROUTES)

    def do_POST(self) -> None:  # noqa: N802
        self._route(_POST_ROUTES)

    def health(self) -> None:
        flt = self.server.flt_health
        if flt is not None:
            try:
                flt.fire()
            except FaultError as e:
                self._json(500, {"error": str(e)})
                return
        stats = self.server.engine.stats()
        # fleet identity and age: the replica router tells replicas apart
        # by the id and a restart by uptime_s resetting (a new process
        # behind the same address)
        stats["replica_id"] = self.server.replica_label()
        stats["uptime_s"] = round(time.monotonic() - self.server.t_start, 3)
        self._json(200 if stats["alive"] else 503, stats)

    def metrics(self) -> None:
        """The server's registry: OpenMetrics (exemplars, ``# EOF``) when
        the client accepts it, else the classic text format."""
        om = OPENMETRICS_ACCEPT in self.headers.get("Accept", "")
        text = self.server.registry.render(openmetrics=om)
        self._send(200, text.encode(),
                   CONTENT_TYPE_OPENMETRICS if om else CONTENT_TYPE_CLASSIC)

    def debug_traces(self) -> None:
        query = {k: v[-1] for k, v in
                 parse_qs(self.query, keep_blank_values=True).items()}
        try:
            limit, since = parse_trace_query(query)
        except ValueError as e:
            self._json(400, {"error": str(e)})
            return
        self._json(200, traces_payload(get_tracer(), limit=limit,
                                       since_us=since))

    def debug_trace_one(self) -> None:
        payload = trace_detail_payload(get_tracer(), self.route_param)
        if payload is None:
            self._json(404, {"error": "trace not in buffer"})
            return
        self._json(200, payload)

    def _attributor(self):
        """The engine's attributor (read through its snapshot methods
        only), or None after a 404 when attribution is off."""
        att = self.server.engine.cb.attribution
        if att is None:
            self._json(404, {"error": "attribution disabled (start without "
                                      "--attributionOff)"})
        return att

    def debug_requests(self) -> None:
        att = self._attributor()
        if att is not None:
            self._json(200, att.request_stats())

    def debug_request_one(self) -> None:
        att = self._attributor()
        if att is None:
            return
        try:
            rid = int(self.route_param)
        except ValueError:
            self._json(400, {"error": "rid must be an integer"})
            return
        record = att.get(rid)
        if record is None:
            self._json(404, {"error": "request not in the timeline buffer"})
            return
        self._json(200, record)

    def debug_slow(self) -> None:
        att = self._attributor()
        if att is not None:
            self._json(200, att.slow_stats())

    def generate(self) -> None:
        server = self.server
        engine = server.engine
        tokenizer = server.tokenizer
        try:
            req = _parse_request(self.read_json(), tokenizer)
            adapter = server.resolve_adapter(req["adapter"])
        except (json.JSONDecodeError, TypeError, ValueError) as e:
            self._json(400, {"error": str(e)})
            return
        try:
            subs = submit_choices(
                engine, req["prompt"], req["n"], req["seed"],
                max_new=req["max_new"], stop=req["stop"],
                sampler=req["sampler"], logit_bias=req["logit_bias"],
                tenant=req["tenant"], priority=req["priority"],
                deadline_ms=req["deadline_ms"],
                resume_out=req["resume_out"], resume_logp=req["resume_logp"],
                kv_pages=req["kv_pages"], adapter=adapter)
        except RequestTooLargeError as e:
            self._json(422, {"error": {"message": str(e),
                                       "code": "request_too_large",
                                       **e.body()}})
            return
        except ValueError as e:
            self._json(422, {"error": str(e)})
            return
        except SchedulerOverloadError as e:  # a full queue or pool
            if engine.cb.scheduler is not None:
                engine.cb.scheduler.count_sync_rejection(engine.cb)
            self._overloaded(str(e), e.reason, e.retry_after)
            return
        except RuntimeError as e:
            self._json(503, {"error": str(e)})
            return
        resumed = list(req["resume_out"] or [])
        if req["stream"]:
            eid, q = subs[0]
            self._stream(engine, eid, q, req["logprobs"], resumed,
                         req["timeline"])
            return
        drained = [drain_queue(q) for _, q in subs]
        err = next((d[2] for d in drained if d[2] is not None), None)
        if err is not None:
            self._json(503, {"error": err.message, "code": err.code})
            return
        infos = [engine.pop_request_info(eid) for eid, _ in subs]
        reject = next((i["reject_reason"] for i in infos
                       if i.get("reject_reason")), None)
        if reject is not None and not any(d[0] for d in drained):
            # rejected while queued, before any token: overload
            self._overloaded(
                "request rejected under overload before admission", reject,
                max((i.get("retry_after", 1) for i in infos), default=1))
            return
        # prompt tokens served from the prefix cache, 0 on a miss or with
        # the cache off (the reference always sends the field); with n > 1
        # the best reuse of any choice
        payload = {"id": subs[0][0], "tokens": drained[0][0],
                   "cached_tokens": max(i.get("cached_tokens", 0)
                                        for i in infos)}
        if req["logprobs"]:
            payload["logprobs"] = drained[0][1]
        if req["timeline"]:
            # the primary choice's record (null under --attributionOff)
            payload["timeline"] = infos[0].get("timeline")
        if req["n"] > 1:
            payload["completions"] = [d[0] for d in drained]
            if req["logprobs"]:
                payload["completions_logprobs"] = [d[1] for d in drained]
        if tokenizer is not None:
            # a resumed request's text covers the whole output
            full = resumed + drained[0][0]
            with get_tracer().span("detokenize", component="serving",
                                   tokens=len(full)):
                payload["text"] = tokenizer.decode(full)
                if req["n"] > 1:
                    payload["completions_text"] = [tokenizer.decode(d[0])
                                                   for d in drained]
        self._json(200, payload)

    def kv_export(self) -> None:
        """``POST /v1/kv/export/{rid}``: the request's KV pages and the
        tokens it emitted, as a body to resubmit to ``/v1/generate`` on
        another replica; the request retires here (its stream closes
        with the tokens delivered so far). 400 for a malformed id, 404
        for an unknown or finished request, 409 while it is queued or
        prefilling (retry after its first token), 503 for the dense
        layout, a dead engine or a timeout."""
        try:
            eid = int(self.route_param)
        except ValueError:
            self._json(400, {"error": "request id must be an integer"})
            return
        try:
            res = self.server.engine.export_kv(eid)
        except KeyError as e:
            self._json(404, {"error": str(e)})
            return
        except ValueError as e:
            self._json(409, {"error": str(e)})
            return
        except (RuntimeError, TimeoutError) as e:
            self._json(503, {"error": str(e)})
            return
        res["id"] = eid
        self._send(200, kv_export_json(res), "application/json")

    def _stream(self, engine: InferenceEngine, eid: int, q: queue.Queue,
                want_logprobs: bool, streamed: list[int],
                want_timeline: bool) -> None:
        """SSE frames of one request; ``streamed`` starts as its resumed
        tokens, so the done event's text covers the whole output."""
        self.start_sse({"X-Request-Id": str(eid)})
        tokenizer = self.server.tokenizer
        try:
            while True:
                item = q.get()
                if item is None:
                    evt = {"done": True}
                    info = engine.pop_request_info(eid)
                    if info.get("reject_reason"):
                        # the stream is open already (200): a rejection
                        # rides the done event
                        evt["rejected"] = info["reject_reason"]
                        evt["retry_after"] = info.get("retry_after", 1)
                    if info.get("cached_tokens"):
                        # only when the cache served part of the prompt:
                        # the common done event stays lean
                        evt["cached_tokens"] = info["cached_tokens"]
                    if want_timeline:
                        evt["timeline"] = info.get("timeline")
                    if tokenizer is not None:
                        with get_tracer().span("detokenize",
                                               component="serving",
                                               tokens=len(streamed)):
                            evt["text"] = tokenizer.decode(streamed)
                elif isinstance(item, StreamError):
                    evt = {"error": {"code": item.code,
                                     "message": item.message}}
                else:
                    streamed.append(item[0])
                    evt = {"token": item[0]}
                    if want_logprobs:
                        evt["logprob"] = item[1]
                self.sse(evt)
                if item is None or isinstance(item, StreamError):
                    return
        except (BrokenPipeError, ConnectionResetError):
            engine.cancel(eid)  # the client went away: free its slot


#: path -> (owner, method): "native" methods are the handler's own,
#: "openai" ones ``serving/openai_api.py``'s ``OpenAIRoutes``
_GET_ROUTES = {"/v1/health": ("native", "health"),
               "/v1/models": ("openai", "models"),
               "/metrics": ("native", "metrics"),
               "/debug/traces": ("native", "debug_traces"),
               "/debug/traces/{trace_id}": ("native", "debug_trace_one"),
               "/debug/requests": ("native", "debug_requests"),
               "/debug/requests/{rid}": ("native", "debug_request_one"),
               "/debug/slow": ("native", "debug_slow")}
_POST_ROUTES = {"/v1/generate": ("native", "generate"),
                "/v1/kv/export/{rid}": ("native", "kv_export"),
                "/v1/completions": ("openai", "completions"),
                "/v1/chat/completions": ("openai", "chat_completions"),
                "/v1/embeddings": ("openai", "embeddings")}


class InferenceServer(ThreadingHTTPServer):
    """The HTTP front of one engine; ``port=0`` binds an ephemeral port
    (read it back from ``bound_port``). ``faults`` arms the
    ``health.handler`` point (``GET /v1/health`` answers 500 when it
    fires). ``tokenizer`` (``serving/tokenizer.py``) serves text;
    ``embedder`` (``serving/embeddings.py``) enables ``/v1/embeddings``
    and ``scorer`` (``serving/scoring.py``) echo prompt scoring: both
    built, and warmed, before the engine thread starts.

    ``registry`` (``metrics/exposition.py``) is this server's own, what
    ``/metrics`` renders (a fresh empty one when not given); ``metrics``
    (the ``ServingMetrics`` on it) and ``span_metrics`` (``--tracing``'s
    span histograms, installed on the process tracer) are released by
    :meth:`stop`, which also turns the tracer off when ``span_metrics``
    says this server turned it on.

    ``replica_id`` is the server's fleet identity (``--replicaId``; empty
    defaults to hostname:port, see :meth:`replica_label`)."""

    daemon_threads = True
    # the listen backlog: a burst of clients connecting at once must queue,
    # not be reset (the standard library's default is 5)
    request_queue_size = 1024

    def __init__(self, engine: InferenceEngine, host: str = "0.0.0.0",
                 port: int = 8000, faults=None, tokenizer=None,
                 embedder=None, scorer=None,
                 registry: "Registry | None" = None,
                 metrics: "ServingMetrics | None" = None,
                 span_metrics: "SpanMetrics | None" = None,
                 replica_id: str = ""):
        super().__init__((host, port), _Handler)
        self.engine = engine
        self.replica_id = replica_id
        self.t_start = time.monotonic()
        self.registry = registry if registry is not None else Registry()
        self.metrics = metrics
        self.span_metrics = span_metrics
        self.tokenizer = tokenizer
        self.embedder = embedder
        self.scorer = scorer
        self.flt_health = (faults.point("health.handler")
                           if faults is not None else None)
        self.bound_port = self.server_address[1]
        # bound at construction, so the label is stable from here on
        self._replica_label = (replica_id or
                               f"{socket.gethostname()}:{self.bound_port}")
        self._thread: "threading.Thread | None" = None

    def replica_label(self) -> str:
        """This replica's stable fleet identity: ``replica_id``, or
        hostname:port once bound. The id ``/v1/health`` reports, the
        router's registry keys on, and every ``serving_http`` span
        carries as its ``replica`` attribute."""
        return self._replica_label

    @property
    def adapter_names(self) -> tuple:
        """The engine's adapter names by index: both APIs resolve names
        here and submit indices. A live read of the batcher's registry
        (a run-time registration is served without a restart); an
        unregistered adapter's "" resolves nowhere."""
        return tuple(getattr(self.engine.cb, "adapter_names", ()))

    def resolve_adapter(self, name) -> int:
        """Adapter name -> index; None or "" -> the base model (-1).
        Raises ValueError for an unknown name (a malformed request, not
        a capacity problem)."""
        if name in (None, ""):
            return -1
        if not isinstance(name, str):
            raise ValueError("adapter must be a string name")
        names = self.adapter_names
        try:
            return names.index(name)
        except ValueError:
            raise ValueError(
                f"unknown adapter {name!r}; serving: "
                f"{[n for n in names if n] or '(none)'}") from None

    def start(self) -> None:
        """Serve on a background thread."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="http-server", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop serving, then stop the engine; unregister this server's
        metric families and detach its span histograms."""
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(10)
        self.engine.shutdown()
        if self.metrics is not None:
            self.metrics.close()
        if self.span_metrics is not None:
            self.span_metrics.close()
            configure(enabled=False)


def load_params(cfg: LlamaConfig, checkpoint_dir: str = "", *,
                seed: int = 0, device: "str | torch.device" = "cuda",
                weight_quant: str = "none") -> dict:
    """Model weights for serving, quantized as ``weight_quant`` says: the
    latest training checkpoint's ``params`` under ``checkpoint_dir`` (the
    only file read; a leaf at a time from the memory-mapped file to
    ``device``), else RANDOM weights on ``device`` from ``seed``
    (loudly). A MoE config's expert stacks are quantized one layer at a
    time on their way to the device, as they are when drawn, so the float
    stacks never exist whole there (Mixtral-8x7B's take 93.4 GB in bf16,
    more than one card holds); the tree equals the whole stacks quantized
    after, bit for bit."""
    expert_leaf = expert_quantizer(weight_quant) if cfg.is_moe else None
    if not checkpoint_dir:
        log.warning("serving RANDOM weights (seed %d, no --checkpointDir): "
                    "smoke mode", seed)
        params = init_params(cfg, seed=seed, device=device,
                             expert_leaf=expert_leaf)
        return quantize_weights(params, weight_quant)
    ckpt = TrainCheckpointer(checkpoint_dir, async_save=False)
    host = ckpt.restore_unstructured(keys=("params",))["params"]
    _check_params_fit(host, cfg, checkpoint_dir)
    dev = resolve_device(device)
    layers = {}
    for name, w in host["layers"].items():
        if name in EXPERT_LEAVES and expert_leaf is not None:
            for i in range(w.shape[0]):
                store_layer(layers, name, i, w.shape[0],
                            expert_leaf(w[i].to(dev)))
        else:
            layers[name] = w.to(dev)
    params = {k: (layers if k == "layers" else v.to(dev))
              for k, v in host.items()}
    log.info("restored params for serving from %s", checkpoint_dir)
    return quantize_weights(params, weight_quant)


def _check_params_fit(params: dict, cfg: LlamaConfig, where: str) -> None:
    """A checkpoint's params must be ``cfg``'s shapes (a preset of
    another size, or another depth, fails here, not mid-forward)."""
    want = {"embed": (cfg.vocab_size, cfg.d_model)}
    want.update({f"layers.{t}": (cfg.n_layers, *dims)
                 for t, dims in target_dims(cfg).items()
                 if not (cfg.is_moe and t in ("w1", "w2", "w3"))})
    for name, shape in want.items():
        leaf = params
        for key in name.split("."):
            leaf = leaf.get(key) if isinstance(leaf, dict) else None
        got = None if leaf is None else tuple(leaf.shape)
        if got != shape:
            raise ValueError(
                f"{where}: params.{name} is {got}, the config wants "
                f"{shape} (a checkpoint of another preset?)")


def load_adapters(cfg: LlamaConfig, spec: str,
                  device: "str | torch.device | None" = None) -> AdapterSet:
    """``--loraAdapters`` value -> AdapterSet (on ``device``; the host
    by default, where an ``AdapterStore`` keeps its registry).

    Syntax: ``name=ckptdir[:alpha=X],name2=dir2``: each dir is a training
    checkpoint whose tree carries the LoRA factors under ``"lora"`` (the
    fine-tune state, ``models/lora.py::init_lora_state``) or at its root.
    Rank and targets are inferred from the factor shapes; alpha defaults
    to the classic 2·rank unless given (it isn't recorded in the
    factors)."""
    adapters = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(
                f"--loraAdapters entry {entry!r}: expected name=ckptdir")
        name, rest = entry.split("=", 1)
        name = name.strip()
        if not name:
            raise ValueError(
                f"--loraAdapters entry {entry!r}: empty adapter name "
                "(it would be unreachable — '' routes to the base model)")
        # imported here: openai_api imports this module
        from k8s_gpu_device_plugin_torch.serving.openai_api import MODEL_ID

        if name == MODEL_ID:
            raise ValueError(
                f"adapter name {name!r} collides with the base model id; "
                "OpenAI-API requests for it would silently serve the base")
        alpha = None
        if ":alpha=" in rest:
            rest, alpha_s = rest.split(":alpha=", 1)
            alpha = float(alpha_s)
        tree = TrainCheckpointer(rest, async_save=False).restore_unstructured()
        lora_params = tree.get("lora", tree)  # fine-tune state or bare factors
        if (not isinstance(lora_params, dict) or not lora_params
                or not all(isinstance(ab, dict) and "a" in ab and "b" in ab
                           for ab in lora_params.values())):
            raise ValueError(
                f"no LoRA factors found in {rest!r} (expected "
                "{target: {'a', 'b'}} under 'lora' or at the tree root)")
        if cfg.is_moe and any(t in ("w1", "w2", "w3") for t in lora_params):
            # the MoE decode path never reads mlp adapter leaves:
            # accepting them would serve a partially applied adapter
            raise ValueError(
                f"adapter {name!r} targets MoE expert MLPs (w1/w2/w3), "
                "which are not LoRA-servable on an MoE config")
        first = next(iter(lora_params.values()))
        rank = int(first["a"].shape[-1])
        dims = target_dims(cfg)
        for t, ab in lora_params.items():
            d_in, d_out = dims.get(t, (None, None))
            if tuple(ab["a"].shape) != (cfg.n_layers, d_in, rank) or \
                    tuple(ab["b"].shape) != (cfg.n_layers, rank, d_out):
                raise ValueError(
                    f"adapter {name!r}: {t} factors a {tuple(ab['a'].shape)}"
                    f", b {tuple(ab['b'].shape)} do not fit the config "
                    f"({cfg.n_layers} layers, {t} {d_in} -> {d_out}, "
                    f"rank {rank})")
        if device is not None:
            dev = resolve_device(device)
            lora_params = {t: {k: v.to(dev) for k, v in ab.items()}
                           for t, ab in lora_params.items()}
        lcfg = LoraConfig(rank=rank,
                          alpha=alpha if alpha is not None else 2.0 * rank,
                          targets=tuple(lora_params))
        adapters.append((name, lora_params, lcfg))
        log.info("loaded LoRA adapter %s from %s (rank %d, targets %s)",
                 name, rest, rank, list(lora_params))
    return stack_adapters(cfg, adapters)


def _eos_arg(value: str):
    """``--eosId``: an integer, or 'none' (argparse's clean usage error
    for anything else)."""
    if value.lower() == "none":
        return "none"
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'none', got {value!r}") from None


def resolve_eos(eos_arg, tokenizer) -> "int | None":
    """The three ``--eosId`` states: unset adopts the tokenizer's EOS
    (none without a tokenizer); 'none' or a negative id turns EOS
    stopping off even with a tokenizer; an id is that id."""
    if eos_arg is None:
        return getattr(tokenizer, "eos_id", None)
    if eos_arg == "none" or int(eos_arg) < 0:
        return None
    return int(eos_arg)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="torch-inference-server")
    parser.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    parser.add_argument("--checkpointDir", default="",
                        help="serve the latest step's params of this "
                        "training checkpoint directory (the trainer's "
                        "--checkpointDir); empty = random weights from "
                        "--seed (smoke mode)")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--slots", type=int, default=8)
    parser.add_argument("--maxLen", type=int, default=2048)
    parser.add_argument("--chunkedPrefill", type=int, default=256,
                        help="prefill in chunks of this many tokens, one "
                        "chunk a step; 0 prefills each prompt whole at "
                        "admission, padded to its bucket (32 ... 1024: a "
                        "longer prompt answers 422)")
    parser.add_argument("--pipelineDepth", type=int, default=1,
                        choices=[0, 1],
                        help="1 dispatches each decode step before the "
                        "previous one is read back; 0 runs the "
                        "synchronous loop")
    parser.add_argument("--tokenizer", default="",
                        help="text seam: 'byte' (UTF-8 bytes, lossless) or "
                        "a local HF tokenizer directory (needs the "
                        "transformers package; nothing is downloaded); "
                        "empty = token-id API only")
    parser.add_argument("--eosId", type=_eos_arg, default=None,
                        help="EOS token id; unset adopts the tokenizer's "
                        "EOS when --tokenizer is given; 'none' (or -1) "
                        "turns EOS stopping off")
    parser.add_argument("--embeddings", action="store_true",
                        help="enable /v1/embeddings (mean-pooled final "
                        "hidden states; base model only, unquantized "
                        "weights)")
    parser.add_argument("--scoring", action="store_true",
                        help="enable /v1/completions echo=true + "
                        "max_tokens=0 prompt scoring (teacher-forced "
                        "logprobs; base model only, unquantized weights)")
    parser.add_argument("--scoringMaxLen", type=int, default=4096,
                        help="longest scorable prompt; past the largest "
                        "bucket (1024) the scorer runs chunks of 512 "
                        "through the cached forward")
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--topK", type=int, default=0)
    parser.add_argument("--topP", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights and of the "
                        "shared sampling generator")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--weightQuant", default="none",
                        choices=list(WEIGHT_QUANTS),
                        help="weight-only quantization of the projection, "
                        "MLP and lm_head weights, applied after they load: "
                        "int8 per output channel, int4 per group of 128 "
                        "input channels (codes packed two per byte)")
    parser.add_argument("--cacheQuant", default="none",
                        choices=["none", "int8", "int4"],
                        help="KV-cache storage: int8 (int4) keeps K/V as "
                        "int8 (int4, two per byte) codes with one f32 scale "
                        "per (position, kv head), on either layout, "
                        "dequantized in the attention kernel")
    parser.add_argument("--kvLayout", default="dense",
                        choices=["dense", "paged"],
                        help="'dense' reserves maxLen rows per slot; "
                        "'paged' maps slots onto a shared page pool "
                        "(memory scales with live tokens); token and "
                        "logprob streams are the same either way")
    parser.add_argument("--kvPageSize", type=int, default=64,
                        help="token rows per KV page with --kvLayout "
                        "paged: a power of two >= 8 that divides --maxLen")
    parser.add_argument("--attnWindow", type=int, default=0,
                        help="sliding-window attention span W (tokens): "
                        "each query attends only the trailing (q-W, q] "
                        "keys; 0 keeps the preset's own window. With "
                        "--kvLayout paged and chunked prefill, pages "
                        "reserve incrementally and pages out of the window "
                        "recycle, so a row's footprint is O(W), not "
                        "O(length)")
    parser.add_argument("--prefillReserveChunks", type=int, default=2,
                        help="windowed admission tranche: prefill chunks' "
                        "worth of pages reserved up front (the rest grow "
                        "chunk by chunk); meaningful with a window and "
                        "--kvLayout paged")
    parser.add_argument("--prefixCacheMB", type=int, default=256,
                        help="device byte budget (MiB) of the automatic "
                        "prefix cache: prompts sharing a cached prefix "
                        "skip its prefill; LRU-evicted under this budget. "
                        "Requires chunked prefill; 0 disables")
    parser.add_argument("--prefixCacheMinHits", type=int, default=1,
                        help="promote a prefix after this many sightings "
                        "(1 = every completed prefill)")
    parser.add_argument("--prefixCacheOff", action="store_true",
                        help="disable the automatic prefix cache (token "
                        "and logprob streams are the same either way)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel shards: weights (q/k/v/"
                        "gate/up/lm_head columns) and the KV cache "
                        "(dense rows or the paged pool, on the KV-head "
                        "axis) shard over a tp-device mesh — tp times "
                        "the KV pages/slots per replica; must divide "
                        "the visible device count and the model's "
                        "n_kv_heads (validated at startup); token/"
                        "logprob streams are bit-identical to --tp 1 on "
                        "a card with both under CUBLAS_WORKSPACE_CONFIG="
                        ":0:0, which --tp > 1 sets when unset (the CPU's "
                        "bf16 products keep that only at small widths, "
                        "not at Llama's)")
    parser.add_argument("--tpPsum", action="store_true",
                        help="with --tp > 1: row-shard the wo/w2 "
                        "contraction axes and sum the shards' partial "
                        "products — one gather fewer per layer, at the "
                        "price of the bit-identity pin (the split "
                        "reduction drifts from --tp 1; explicit "
                        "opt-out, off by default)")
    parser.add_argument("--kvPages", type=int, default=0,
                        help="physical pages in the paged pool, the "
                        "reserved trap page included; 0 sizes it to the "
                        "dense reservation")
    parser.add_argument("--draftPreset", default="",
                        choices=["", *sorted(PRESETS)],
                        help="enable speculative decoding with this draft "
                        "model preset (greedy or sampled; repetition "
                        "penalty unsupported). Composes with the serving "
                        "path: --kvLayout paged pages both caches, the "
                        "automatic prefix cache serves the target zero-copy "
                        "(the draft re-prefills the match), "
                        "--pipelineDepth 1 overlaps rounds")
    parser.add_argument("--draftCheckpointDir", default="",
                        help="with --draftPreset: the draft's weights from "
                        "this training checkpoint directory (empty = "
                        "random from --seed, shared with the target when "
                        "the presets match)")
    parser.add_argument("--gamma", type=int, default=4,
                        help="draft proposals verified per round (1 .. 16; "
                        "/v1/health's spec.accepted_per_round near gamma "
                        "says raise it, near 1 lower it)")
    parser.add_argument("--draftKvPages", type=int, default=0,
                        help="with --draftPreset and --kvLayout paged: "
                        "physical pages in the draft model's KV pool (0 "
                        "sizes it to the draft's dense-equivalent "
                        "capacity)")
    parser.add_argument("--schedPolicy", default="fifo",
                        choices=["fifo", "slo"],
                        help="admission policy: 'fifo' is arrival order "
                        "(the same streams as no scheduler); 'slo' orders "
                        "by priority class, per-tenant weighted fairness "
                        "and earliest deadline, enforces --tenantQuota, "
                        "and preempts a lower-class decode when a "
                        "deadline would be missed (not with --draftPreset: "
                        "the speculative engine has no resume path)")
    parser.add_argument("--tenantQuota", default="",
                        help="per-tenant token buckets and fair-queuing "
                        "weights (needs --schedPolicy slo): "
                        "name=rate[:burst=B][:weight=W],... with rate in "
                        "tokens/s; an over-quota tenant is demoted, "
                        "never dropped")
    parser.add_argument("--adapterQuota", default="",
                        help="per-adapter hard rate limits: "
                        "name=rate[:burst=B],... (tokens/s of prompt + "
                        "budgeted output; burst defaults to 4x rate). "
                        "Enforced under every --schedPolicy: an over-"
                        "quota submit answers 429 with Retry-After")
    parser.add_argument("--loraAdapters", default="",
                        help="multi-LoRA from training checkpoints: "
                        "name=ckptdir[:alpha=X],... (the factors under "
                        "'lora' or at the tree root; rank and targets "
                        "inferred, alpha 2*rank unless given); requests "
                        "pick one by 'adapter' or the OpenAI 'model'")
    parser.add_argument("--adapterCacheMB", type=int, default=0,
                        help="multi-LoRA device residency budget in MiB "
                        "(models/lora_serving.AdapterStore): adapters past "
                        "it stay on the host and upload on demand, off the "
                        "engine thread, LRU-evicting idle ones; 0 = every "
                        "registered adapter stays resident")
    parser.add_argument("--defaultDeadlineMs", type=int, default=0,
                        help="deadline of a request that names none (0 = "
                        "no deadline)")
    parser.add_argument("--maxQueue", type=int, default=0,
                        help="pending-request cap (0 = unbounded): past it "
                        "a submission answers 429 with Retry-After")
    parser.add_argument("--deferBudgetMs", type=int, default=0,
                        help="how long a request may wait at the queue head "
                        "on pool pressure before it is rejected with 429 "
                        "(0 = forever)")
    parser.add_argument("--restartBudget", type=int, default=3,
                        help="engine crash recoveries allowed per rolling "
                        "--restartWindowS: within it a crashed engine "
                        "rebuilds in place, replays its queue in order and "
                        "resumes its streams; past it (or with 0) it dies "
                        "and every stream ends with a structured error")
    parser.add_argument("--restartWindowS", type=float, default=300.0,
                        help="rolling window of --restartBudget")
    parser.add_argument("--faults", default="",
                        help="seeded fault injection: armed points with "
                        "schedules, e.g. 'decode.apply:nth=40,pool.alloc:"
                        "p=0.25:seed=3:times=6'; also read from "
                        "TPU_SERVING_FAULTS; empty = disarmed")
    parser.add_argument("--replicaId", default="",
                        help="stable fleet identity reported on "
                        "/v1/health (serving/router.py's registry and "
                        "dashboards key on it); empty = hostname:port")
    parser.add_argument("--tracing", action="store_true",
                        help="span tracing (obs/): request span trees on "
                        "GET /debug/traces, trace ids in JSON logs, span-"
                        "duration histograms on /metrics; default off")
    parser.add_argument("--traceSteps", action="store_true",
                        help="with --tracing: a span per decode dispatch "
                        "and readback (batch-scoped traces; shows the "
                        "pipeline overlap)")
    parser.add_argument("--attributionOff", action="store_true",
                        help="disable per-request latency attribution and "
                        "the live MFU accounting: no timelines on the done "
                        "payloads or /debug/requests, no /debug/slow flight "
                        "recorder, no mfu on /v1/health (token and logprob "
                        "streams are the same either way)")
    parser.add_argument("--slowRequestMs", type=float, default=0.0,
                        help="flight-recorder threshold: requests at least "
                        "this slow keep their step-level detail on GET "
                        "/debug/slow (deadline misses always do); 0 = the "
                        "window's p99 once 32 requests have retired")
    return parser


def _at_depth_of(cfg: LlamaConfig, checkpoint_dir: str) -> LlamaConfig:
    """``cfg`` at the depth of the latest step under ``checkpoint_dir``
    (the leading dimension of its layer stacks; ``cfg`` itself without a
    directory): a run trained at a cut depth serves at that depth, and
    ``load_params`` holds the widths to the preset's."""
    if not checkpoint_dir:
        return cfg
    host = TrainCheckpointer(checkpoint_dir, async_save=False) \
        .restore_unstructured(keys=("params",))["params"]
    depths = {int(w.shape[0]) for w in host["layers"].values()}
    if len(depths) != 1:
        raise ValueError(f"{checkpoint_dir}: the layer stacks' depths "
                         f"{sorted(depths)} differ")
    return replace(cfg, n_layers=depths.pop())


def build_server(args: argparse.Namespace,
                 params: "dict | None" = None,
                 adapters=None, tp_devices=None) -> InferenceServer:
    """Parsed CLI flags -> a bound (not yet serving) server: resolves the
    device first (no CUDA and no ``--device cpu`` raises before any
    weights are drawn), then loads weights and starts the engine.
    ``params`` serves the caller's weights (already on the device, for
    the preset, and quantized as ``--weightQuant`` says) instead of
    drawing a set: a process that starts several servers on one card
    draws once. ``adapters`` (an ``AdapterSet`` or an ``AdapterStore``,
    ``models/lora_serving.py``) serves multi-LoRA: a set becomes one
    store under ``--adapterCacheMB``, and every batcher the supervisor
    builds serves that store, so its registry survives a restart.
    ``tp_devices`` names the ``--tp`` mesh's devices, one a shard, and
    may repeat one (``["cuda:0"] * tp``): torch has no forced device
    count, so this in-process seam stands in for one; the command line
    has no such flag and shards over the visible cards."""
    device = resolve_device(args.device)
    if args.kvLayout == "dense" and (args.kvPages or args.kvPageSize != 64):
        # 64 is --kvPageSize's default, the one value that cannot be told
        # apart from "not passed"
        raise ValueError(
            "--kvPages/--kvPageSize have no effect under --kvLayout dense "
            "(the dense cache reserves slots*maxLen rows); add --kvLayout "
            "paged"
        )
    if args.attnWindow < 0:
        raise ValueError("--attnWindow must be >= 0 (0 keeps the preset's "
                         "window)")
    if args.draftKvPages and (args.kvLayout != "paged"
                              or not args.draftPreset):
        raise ValueError(
            "--draftKvPages sizes the speculative draft model's page pool: "
            "it needs both --draftPreset and --kvLayout paged"
        )
    if args.prefillReserveChunks < 1:
        raise ValueError("--prefillReserveChunks must be >= 1: the tranche "
                         "has to cover the chunk being prefilled")
    if args.loraAdapters and args.draftPreset:
        raise ValueError(
            "--loraAdapters is unsupported with --draftPreset: the "
            "draft model has no adapter stacks to mirror the target's")
    if args.loraAdapters and adapters is not None:
        raise ValueError("adapters passed in process and --loraAdapters: "
                         "serve one registry")
    if args.draftCheckpointDir and not args.draftPreset:
        raise ValueError("--draftCheckpointDir loads the speculative draft "
                         "model: it needs --draftPreset")
    if params is not None and args.checkpointDir:
        raise ValueError("params passed in process and --checkpointDir: "
                         "serve one set of weights")
    if adapters is not None and args.draftPreset:
        raise ValueError(
            "adapters are unsupported with --draftPreset: the draft model "
            "has no adapter stacks to mirror the target's")
    if args.adapterCacheMB < 0:
        raise ValueError("--adapterCacheMB must be >= 0")
    if args.adapterCacheMB and adapters is None and not args.loraAdapters:
        raise ValueError(
            "--adapterCacheMB needs adapters: a residency budget with no "
            "adapters to hold would silently do nothing")
    for flag, on in (("--embeddings", args.embeddings),
                     ("--scoring", args.scoring)):
        if on and args.weightQuant != "none":
            raise ValueError(
                f"{flag} is unsupported with --weightQuant: the non-cached "
                "forward cannot consume quantized leaves")
    tokenizer = load_tokenizer(args.tokenizer)
    scheduler = make_scheduler(
        args.schedPolicy, max_queue=args.maxQueue,
        defer_budget_ms=args.deferBudgetMs, tenant_quota=args.tenantQuota,
        adapter_quota=args.adapterQuota,
        # the speculative engine has no resume path: the slo policy still
        # orders its queue, without preemption
        preempt=not args.draftPreset)
    supervisor = EngineSupervisor(max_restarts=args.restartBudget,
                                  window_s=args.restartWindowS)
    faults = FaultPlane.from_cli(args.faults)
    cfg = _at_depth_of(replace(PRESETS[args.preset](),
                               cache_quant=args.cacheQuant),
                       args.checkpointDir)
    if args.attnWindow:
        cfg = replace(cfg, sliding_window=args.attnWindow)
    if args.tp != 1:
        # before the weight load: the shared flag rule checks tp against
        # the device count and the model's KV-head count
        n_devices = (len(tp_devices) if tp_devices is not None
                     else torch.cuda.device_count() if device.type == "cuda"
                     else 1)
        MeshSpec.from_flags(tp=args.tp, n_devices=n_devices,
                            n_kv_heads=cfg.n_kv_heads, exact=True)
    elif tp_devices is not None:
        raise ValueError("tp_devices names the devices of a --tp > 1 mesh")
    if args.tpPsum:
        if args.tp == 1:
            raise ValueError("--tpPsum needs --tp > 1: there is no "
                             "collective to save on one shard")
        cfg = replace(cfg, tp_allow_psum=True)
    # the server's own registry and families; attribution and the live
    # roofline are on unless --attributionOff (the reference's default),
    # priced at the serving card's peaks (a card missing from the table
    # raises here, before any weights are drawn)
    registry = Registry()
    metrics = ServingMetrics(registry)
    attribution = mfu = None
    if not args.attributionOff:
        attribution = RequestAttributor(slow_ms=args.slowRequestMs,
                                        metrics=metrics)
        # priced at the cards the mesh spans (repeats count once)
        cards = (args.tp if tp_devices is None
                 else len({str(d) for d in tp_devices[:args.tp]}))
        mfu = MfuAccumulator(ServingCostModel.for_config(cfg, device=device,
                                                         tp=cards),
                             metrics=metrics)
    # the automatic prefix cache: on wherever it can work (chunked
    # prefill continues a prefill from the matched boundary), over the
    # bucket ladder cut at --maxLen
    prefix_cache = None
    buckets = tuple(b for b in DEFAULT_PROMPT_BUCKETS if b <= args.maxLen)
    if (not args.prefixCacheOff and args.prefixCacheMB > 0
            and args.chunkedPrefill > 0 and buckets):
        prefix_cache = PrefixCache(cfg, buckets=buckets,
                                   budget_bytes=args.prefixCacheMB << 20,
                                   min_hits=args.prefixCacheMinHits,
                                   metrics=metrics)
    if params is None:
        params = load_params(cfg, args.checkpointDir, seed=args.seed,
                             device=device, weight_quant=args.weightQuant)
    elif weight_quant_of(params) != args.weightQuant:
        raise ValueError(
            f"the params passed in are quantized {weight_quant_of(params)!r}"
            f", --weightQuant says {args.weightQuant!r}"
        )
    if args.loraAdapters:
        adapters = load_adapters(cfg, args.loraAdapters)
    if isinstance(adapters, AdapterSet):
        adapters = AdapterStore.from_set(
            cfg, adapters, cache_bytes=args.adapterCacheMB << 20)
    elif adapters is not None and args.adapterCacheMB and \
            adapters.cache_bytes != args.adapterCacheMB << 20:
        raise ValueError(
            f"--adapterCacheMB {args.adapterCacheMB} differs from the "
            f"AdapterStore's own budget ({adapters.cache_bytes} bytes)")
    # the auxiliary forwards are built, and run once a bucket, on this
    # thread before the engine thread starts (on a card: the kernels'
    # builds and first launches)
    embedder = Embedder(params, cfg) if args.embeddings else None
    scorer = (Scorer(params, cfg, max_len=args.scoringMaxLen)
              if args.scoring else None)
    common = dict(
        n_slots=args.slots, max_len=args.maxLen,
        eos_id=resolve_eos(args.eosId, tokenizer),
        sampler=Sampler(temperature=args.temperature, top_k=args.topK,
                        top_p=args.topP),
        seed=args.seed, pipeline_depth=args.pipelineDepth,
        kv_layout=args.kvLayout,
        kv_page_size=args.kvPageSize if args.kvLayout == "paged" else None,
        kv_pages=args.kvPages, prefix_cache=prefix_cache,
        prefill_reserve_chunks=args.prefillReserveChunks,
        scheduler=scheduler, faults=faults, metrics=metrics,
        trace_steps=args.traceSteps and args.tracing,
        attribution=attribution, mfu=mfu)
    if args.tp > 1:
        common.update(tp=args.tp, tp_devices=tp_devices)
    if args.draftPreset:
        draft_cfg = _at_depth_of(PRESETS[args.draftPreset](),
                                 args.draftCheckpointDir)
        # the draft is loaded as the target is (its checkpoint, or --seed;
        # then --weightQuant): a draft of the target's own preset from
        # the same source would be the same tensors, so it shares them
        # instead of holding a second copy
        same = (args.draftPreset == args.preset
                and args.draftCheckpointDir == args.checkpointDir)
        draft_params = params if same else load_params(
            draft_cfg, args.draftCheckpointDir, seed=args.seed,
            device=device, weight_quant=args.weightQuant)
        # no recipe: the speculative engine has no resume path, so a
        # crash ends it (with the structured error frames)
        engine = InferenceEngine(SpeculativeBatcher(
            params, cfg, draft_params, draft_cfg, gamma=args.gamma,
            draft_kv_pages=args.draftKvPages,
            chunked_prefill=min(args.chunkedPrefill, args.maxLen), **common),
            default_deadline_ms=args.defaultDeadlineMs)
    else:
        # the recipe: the supervisor rebuilds the batcher from it after a
        # crash, around the same weights, cache, scheduler and faults
        def make_batcher() -> ContinuousBatcher:
            return ContinuousBatcher(
                params, cfg, chunked_prefill=args.chunkedPrefill,
                adapters=adapters, **common)

        engine = InferenceEngine(make_batcher=make_batcher,
                                 supervisor=supervisor,
                                 default_deadline_ms=args.defaultDeadlineMs,
                                 tp=args.tp)
    # tracing last: nothing above may fail with the process tracer on
    span_metrics = None
    if args.tracing:
        span_metrics = SpanMetrics(registry).install(configure(enabled=True))
    return InferenceServer(engine, host=args.host, port=args.port,
                           faults=faults, tokenizer=tokenizer,
                           embedder=embedder, scorer=scorer,
                           registry=registry, metrics=metrics,
                           span_metrics=span_metrics,
                           replica_id=args.replicaId)


def _main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    if args.tp > 1:
        # before any cuBLAS handle: no workspace, so a column shard's
        # product keeps the whole product's K order (parallel/tp_serving)
        for key, value in EXACT_CUBLAS_ENV.items():
            os.environ.setdefault(key, value)
    try:
        server = build_server(args)
    except (RuntimeError, ValueError) as e:  # no CUDA; a refused config
        print(f"error: {e}", file=sys.stderr)
        return 2
    log.info("serving %s on %s:%d (%s)", args.preset, args.host,
             server.bound_port, server.engine.cb.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.engine.shutdown()
        if server.span_metrics is not None:
            server.span_metrics.close()
            configure(enabled=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
