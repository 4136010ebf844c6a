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
  {"token_id": bias, ...}}`` ->
  ``{"id", "tokens", "cached_tokens"[, "logprobs"]}``, or with
  ``"stream": true`` a ``text/event-stream`` of ``data: {"token": t[,
  "logprob": lp]}`` frames closing with ``data: {"done": true}``.
  ``cached_tokens`` counts the prompt tokens a prefix cache served; no
  prefix cache is ported, so it is always 0, and the done event leaves
  it out, as the reference's does at 0. A field the port does
  not implement yet (``n`` other than 1, ``adapter``, ``text``,
  ``stop_text``, the scheduling and resume fields, ...) answers 400
  naming it, as does a ``logit_bias`` that is not an object of integer
  keys and numbers; a request no slot can hold, a bias outside the
  batcher's bounds, or (with ``--chunkedPrefill 0``) a prompt longer than
  the largest bucket answers 422.
- ``GET /v1/health`` -> slots, active, prefilling, queued, alive, the
  attention backend plan (``decode_attn``), the KV residency (``kv``:
  layout, reserved bytes and, paged, the pool's occupancy, fragmentation
  and the admissions it refused or made to wait), the weights
  (``weights``: their quantization and resident bytes), the device,
  decode-step and prefill counts, how the decode step runs (``decode``:
  the pipeline depth and flushes, and on a card the captured CUDA
  graph's pool bytes, replays and launches a replay makes) and the
  kernels' launch counts.

Run: ``python -m k8s_gpu_device_plugin_torch.serving.server --preset
llama3_8b --port 8731`` (random weights drawn on the card from
``--seed``; ``--device cpu`` serves on the CPU). ``--kvLayout paged
--kvPageSize 64 --kvPages N`` serves from a pool of N pages (the trap
page included; 0 sizes it to the dense reservation); ``--cacheQuant
int8`` (or ``int4``) keeps K/V as int8 (int4) codes with f32 scales, on
either layout; ``--weightQuant int8|int4`` quantizes the projection,
MLP and lm_head weights after they load (weight-only, as the reference's
server does). ``--pipelineDepth 1`` (the default) dispatches each decode
step before the previous one is read back, 0 runs the synchronous loop;
``--chunkedPrefill 0`` prefills each prompt whole at admission, padded to
its bucket, instead of in chunks of 256.
"""

from __future__ import annotations

import argparse
import collections
import json
import queue
import statistics
import sys
import threading
from dataclasses import replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from k8s_gpu_device_plugin_torch.device import resolve_device
from k8s_gpu_device_plugin_torch.models.batching import (
    ContinuousBatcher,
    RequestTooLargeError,
)
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig, init_params
from k8s_gpu_device_plugin_torch.models.quantized_serving import (
    WEIGHT_QUANTS,
    quantize_weights,
    weight_quant_of,
)
from k8s_gpu_device_plugin_torch.models.sampling import Sampler
from k8s_gpu_device_plugin_torch.ops.kernel_support import launch_counts
from k8s_gpu_device_plugin_torch.utils.log import get_logger

log = get_logger()

PRESETS = {
    "tiny": LlamaConfig.tiny,
    "llama3_8b": LlamaConfig.llama3_8b,
    "llama3_70b": LlamaConfig.llama3_70b,
    "mistral_7b": LlamaConfig.mistral_7b,
}

_KNOBS = {"temperature": float, "top_k": int, "top_p": float,
          "repetition_penalty": float}
_FIELDS = {"prompt", "max_new", "stream", "logprobs", "stop", "seed", "n",
           "logit_bias", *_KNOBS}


class StreamError:
    """End-of-stream marker for a stream the engine could not finish."""

    def __init__(self, code: str, message: str):
        self.code = code
        self.message = message


class InferenceEngine:
    """Background thread around a ContinuousBatcher with per-request
    token queues. ``submit`` is thread-safe; each queue receives
    ``(token, logprob)`` pairs, then ``None`` at end of stream (preceded
    by a :class:`StreamError` if the engine died)."""

    def __init__(self, params: dict, cfg: LlamaConfig, n_slots: int = 8,
                 max_len: int = 2048, sampler: "Sampler | None" = None,
                 eos_id: "int | None" = None, chunked_prefill: int = 256,
                 seed: int = 0, kv_layout: "str | None" = None,
                 kv_page_size: "int | None" = None, kv_pages: int = 0,
                 pipeline_depth: int = 1):
        self.cb = ContinuousBatcher(
            params, cfg, n_slots=n_slots, max_len=max_len, sampler=sampler,
            eos_id=eos_id, chunked_prefill=chunked_prefill, seed=seed,
            kv_layout=kv_layout, kv_page_size=kv_page_size,
            kv_pages=kv_pages, pipeline_depth=pipeline_depth,
        )
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._dead = threading.Event()
        self._subq: list[tuple] = []     # owner: request threads -> engine
        self._cancelq: list[int] = []
        self._streams: dict[int, queue.Queue] = {}  # eid -> token queue
        self._published: dict[int, int] = {}        # eid -> tokens pushed
        self._rid_to_eid: dict[int, int] = {}       # owner: engine thread
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
               logit_bias=None) -> tuple[int, queue.Queue]:
        """Validate (everything the batcher would) and queue a request.
        Returns (engine id, its token queue)."""
        if self._dead.is_set():
            raise RuntimeError("inference engine is dead (see logs)")
        prompt = self.cb.validate_prompt(prompt)
        self.cb.validate(len(prompt), max_new)
        bias = self.cb.validate_bias(logit_bias)
        seed = self.cb.validate_seed(seed)
        q: queue.Queue = queue.Queue()
        with self._lock:
            eid = self._next_eid
            self._next_eid += 1
            self._subq.append((eid, prompt, max_new, stop, sampler, seed,
                               bias))
            self._streams[eid] = q
            self._published[eid] = 0
        self._work.set()
        return eid, q

    def cancel(self, eid: int) -> None:
        """Queue a cancellation (a client that went away frees its slot)."""
        with self._lock:
            self._cancelq.append(eid)
        self._work.set()

    def stats(self) -> dict:
        with self._lock:
            queued_local = len(self._subq)
            ttft = list(self._ttft_s)
        cb = self.cb
        decode_s = cb.decode_s
        return {
            "slots": cb.n_slots,
            "active": len(cb.running),
            "prefilling": len(cb.prefilling),
            "queued": len(cb.pending) + queued_local,
            "alive": not self._dead.is_set(),
            "device": str(cb.device),
            "decode_attn": cb.attn_plan,
            "kv": {**cb.kv_stats(), "admission_rejected": cb.kv_rejections()},
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
        for eid, prompt, max_new, stop, sampler, seed, bias in batch:
            rid = self.cb.submit(prompt, max_new, stop=stop, sampler=sampler,
                                 seed=seed, logit_bias=bias)
            self._rid_to_eid[rid] = eid

    def _apply_cancellations(self) -> None:
        with self._lock:
            cancels, self._cancelq = self._cancelq, []
        for eid in cancels:
            rid = next((r for r, e in self._rid_to_eid.items() if e == eid),
                       None)
            if rid is not None:
                self.cb.cancel(rid)

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

    def _publish(self) -> None:
        """Push new (token, logprob) pairs; close finished streams."""
        for req in list(self.cb.running.values()):
            self._push(req.rid, req.out, req.out_logp)
        for rid in list(self._rid_to_eid):
            req = self.cb.done_requests.pop(rid, None)
            if req is None:
                continue
            self._push(rid, req.out, req.out_logp)
            self.cb.done.pop(rid, None)
            eid = self._rid_to_eid.pop(rid)
            with self._lock:
                q = self._streams.pop(eid, None)
                self._published.pop(eid, None)
                if req.t_first_tok:
                    self._ttft_s.append(req.t_first_tok - req.t_submit)
            if q is not None:
                q.put(None)

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                self._admit_submissions()
                self._apply_cancellations()
                cb = self.cb
                if cb.pending or cb.running or cb.prefilling:
                    cb.step()
                self._publish()
                if not (cb.pending or cb.running or cb.prefilling):
                    self._work.wait(timeout=0.05)
                    self._work.clear()
        except Exception as exc:  # noqa: BLE001 - the engine's crash boundary
            log.exception("inference engine loop died")
            self._dead.set()
            with self._lock:
                streams, self._streams = self._streams, {}
            err = StreamError("engine_dead",
                              f"inference engine died: {type(exc).__name__}: {exc}")
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


def _parse_request(body) -> dict:
    """The /v1/generate body -> submit kwargs (+ stream/logprobs flags).
    Raises ValueError with a message naming the offending field."""
    if not isinstance(body, dict):
        raise ValueError("the request body must be a JSON object")
    for name in body:
        if name not in _FIELDS:
            raise ValueError(
                f"field {name!r} is not implemented by this server yet"
            )
    if body.get("n", 1) != 1:
        raise ValueError("field 'n' is not implemented by this server yet "
                         "(n=1 only)")
    if "prompt" not in body:
        raise ValueError("field 'prompt' is required")
    prompt = body["prompt"]
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in prompt)):
        raise ValueError("prompt must be a non-empty list of token ids")
    max_new = body.get("max_new", 64)
    if not isinstance(max_new, int) or isinstance(max_new, bool):
        raise ValueError("max_new must be an integer")
    stop = body.get("stop", [])
    if not isinstance(stop, list) or not all(
        isinstance(st, list) and st and all(isinstance(t, int) for t in st)
        for st in stop
    ):
        raise ValueError("stop must be a list of token-id lists")
    given = {k: cast(body[k]) for k, cast in _KNOBS.items() if k in body}
    return {
        "prompt": prompt, "max_new": max_new, "stop": stop,
        "sampler": Sampler(**given) if given else None,
        "seed": body.get("seed"),
        "logit_bias": _parse_logit_bias(body.get("logit_bias")),
        "stream": bool(body.get("stream", False)),
        "logprobs": bool(body.get("logprobs", False)),
    }


class _Handler(BaseHTTPRequestHandler):
    server: "InferenceServer"

    def log_message(self, fmt, *args) -> None:  # route access logs to debug
        log.debug("http: " + fmt, *args)

    def _json(self, status: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 - http.server's naming
        if self.path != "/v1/health":
            self._json(404, {"error": f"no route {self.path}"})
            return
        stats = self.server.engine.stats()
        self._json(200 if stats["alive"] else 503, stats)

    def do_POST(self) -> None:  # noqa: N802
        if self.path != "/v1/generate":
            self._json(404, {"error": f"no route {self.path}"})
            return
        engine = self.server.engine
        try:
            n = int(self.headers.get("Content-Length", "0"))
            req = _parse_request(json.loads(self.rfile.read(n) or b"null"))
        except (json.JSONDecodeError, TypeError, ValueError) as e:
            self._json(400, {"error": str(e)})
            return
        try:
            eid, q = engine.submit(req["prompt"], req["max_new"],
                                   stop=req["stop"], sampler=req["sampler"],
                                   seed=req["seed"],
                                   logit_bias=req["logit_bias"])
        except RequestTooLargeError as e:
            self._json(422, {"error": {"message": str(e),
                                       "code": "request_too_large",
                                       **e.body()}})
            return
        except ValueError as e:
            self._json(422, {"error": str(e)})
            return
        except RuntimeError as e:
            self._json(503, {"error": str(e)})
            return
        if req["stream"]:
            self._stream(engine, eid, q, req["logprobs"])
            return
        toks, lps = [], []
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, StreamError):
                self._json(503, {"error": item.message, "code": item.code})
                return
            toks.append(item[0])
            lps.append(item[1])
        # the reference always sends cached_tokens (0 on a prefix-cache
        # miss); the port has no prefix cache, so every request misses
        payload = {"id": eid, "tokens": toks, "cached_tokens": 0}
        if req["logprobs"]:
            payload["logprobs"] = lps
        self._json(200, payload)

    def _stream(self, engine: InferenceEngine, eid: int, q: queue.Queue,
                want_logprobs: bool) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("X-Request-Id", str(eid))
        self.end_headers()
        try:
            while True:
                item = q.get()
                if item is None:
                    evt = {"done": True}
                elif isinstance(item, StreamError):
                    evt = {"error": {"code": item.code,
                                     "message": item.message}}
                else:
                    evt = {"token": item[0]}
                    if want_logprobs:
                        evt["logprob"] = item[1]
                self.wfile.write(f"data: {json.dumps(evt)}\n\n".encode())
                self.wfile.flush()
                if item is None or isinstance(item, StreamError):
                    return
        except (BrokenPipeError, ConnectionResetError):
            engine.cancel(eid)  # the client went away: free its slot


class InferenceServer(ThreadingHTTPServer):
    """The HTTP front of one engine; ``port=0`` binds an ephemeral port
    (read it back from ``bound_port``)."""

    daemon_threads = True

    def __init__(self, engine: InferenceEngine, host: str = "0.0.0.0",
                 port: int = 8000):
        super().__init__((host, port), _Handler)
        self.engine = engine
        self.bound_port = self.server_address[1]
        self._thread: "threading.Thread | None" = None

    def start(self) -> None:
        """Serve on a background thread."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="http-server", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop serving, then stop the engine."""
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(10)
        self.engine.shutdown()


def load_params(cfg: LlamaConfig, *, seed: int = 0,
                device: "str | torch.device" = "cuda") -> dict:
    """Model weights for serving. No checkpoint format is ported yet, so
    this draws RANDOM weights on ``device`` from ``seed`` (loudly)."""
    log.warning("serving RANDOM weights (seed %d): smoke mode", seed)
    return init_params(cfg, seed=seed, device=device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="torch-inference-server")
    parser.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
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
    parser.add_argument("--kvPages", type=int, default=0,
                        help="physical pages in the paged pool, the "
                        "reserved trap page included; 0 sizes it to the "
                        "dense reservation")
    return parser


def build_server(args: argparse.Namespace,
                 params: "dict | None" = None) -> InferenceServer:
    """Parsed CLI flags -> a bound (not yet serving) server: resolves the
    device first (no CUDA and no ``--device cpu`` raises before any
    weights are drawn), then loads weights and starts the engine.
    ``params`` serves the caller's weights (already on the device, for
    the preset, and quantized as ``--weightQuant`` says) instead of
    drawing a set: a process that starts several servers on one card
    draws once."""
    device = resolve_device(args.device)
    if args.kvLayout == "dense" and (args.kvPages or args.kvPageSize != 64):
        # 64 is --kvPageSize's default, the one value that cannot be told
        # apart from "not passed"
        raise ValueError(
            "--kvPages/--kvPageSize have no effect under --kvLayout dense "
            "(the dense cache reserves slots*maxLen rows); add --kvLayout "
            "paged"
        )
    cfg = replace(PRESETS[args.preset](), cache_quant=args.cacheQuant)
    if params is None:
        params = load_params(cfg, seed=args.seed, device=device)
        params = quantize_weights(params, args.weightQuant)
    elif weight_quant_of(params) != args.weightQuant:
        raise ValueError(
            f"the params passed in are quantized {weight_quant_of(params)!r}"
            f", --weightQuant says {args.weightQuant!r}"
        )
    engine = InferenceEngine(
        params, cfg, n_slots=args.slots, max_len=args.maxLen,
        sampler=Sampler(temperature=args.temperature, top_k=args.topK,
                        top_p=args.topP),
        chunked_prefill=args.chunkedPrefill, seed=args.seed,
        pipeline_depth=args.pipelineDepth, kv_layout=args.kvLayout,
        kv_page_size=args.kvPageSize if args.kvLayout == "paged" else None,
        kv_pages=args.kvPages,
    )
    return InferenceServer(engine, host=args.host, port=args.port)


def _main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
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
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
