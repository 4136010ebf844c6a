"""OpenAI-compatible façade over the inference server.

Port of ``k8s_gpu_device_plugin_tpu/serving/openai_api.py`` onto the
port's ``http.server`` handler: the server's route table
(``serving/server.py``, ``_GET_ROUTES`` / ``_POST_ROUTES``) sends these
paths here, to the same engine (request and response translation only,
no second serving path):

- ``POST /v1/completions``: ``prompt`` a string (tokenizer required) or
  a token-id list checked against the vocabulary; ``n`` <= 8 and
  ``best_of`` (ranked by mean token logprob); ``max_tokens`` (default
  16); ``stop``, a string or up to 4 (trimmed from the text; streams
  hold back the last ``max(stop)`` tokens); ``temperature`` / ``top_p``
  build a per-request ``Sampler`` (neither runs the server's sampler,
  so a speculative engine still serves the request); ``logit_bias``,
  ``seed`` and the SLO fields; ``logprobs`` 0 ... 5; SSE chunks closing
  with ``data: [DONE]``. ``echo=true`` with ``max_tokens=0`` scores the
  prompt (``serving/scoring.py``, ``--scoring``).
- ``POST /v1/chat/completions``: ``messages`` through the HF tokenizer's
  chat template when it has one, else a role-tagged template; an absent
  ``max_tokens`` means the slot's remaining budget; streams carry role
  and content deltas.
- ``GET /v1/models``: the base model and every live LoRA adapter's name
  (unregistered adapters' tombstones are not listed).
- ``POST /v1/embeddings`` (``--embeddings``): strings or token-id lists.

Errors use OpenAI's envelope (``error.type`` ``invalid_request_error``,
``server_error`` for 5xx, ``rate_limit_error`` with ``Retry-After`` for
429). ``"timeline": true`` adds the primary choice's latency timeline to
the (non-streamed) envelope, null with ``--attributionOff``, as the
reference's extension field. The ``model`` field routes: the base
model's id (or none) serves the base model, a live adapter's name that
adapter; anything else answers 404 ``model_not_found``. Echo scoring and
embeddings serve the base model only, as the reference documents.
"""

from __future__ import annotations

import json
import time
import uuid

from k8s_gpu_device_plugin_torch.models.batching import (
    ContinuousBatcher,
    RequestTooLargeError,
)
from k8s_gpu_device_plugin_torch.models.sampling import Sampler
from k8s_gpu_device_plugin_torch.serving.scheduler import (
    SchedulerOverloadError,
)
from k8s_gpu_device_plugin_torch.serving.server import (
    MAX_N,
    _is_ids,
    _parse_logit_bias,
    drain_queue,
    submit_choices,
)
from k8s_gpu_device_plugin_torch.serving.supervisor import StreamError
from k8s_gpu_device_plugin_torch.serving.tokenizer import (
    encode_stop_strings,
    trim_stop_suffix,
)

MODEL_ID = "tpu-serving"  # the base model's id on the wire (the reference's)
MAX_EMBED_INPUTS = 64     # one forward an input, in turn


class _ModelNotFound(Exception):
    """A "model" this server does not serve: OpenAI answers 404."""

    def __init__(self, model: str) -> None:
        super().__init__(
            f"The model {model!r} does not exist or is not served here"
        )


class _TextDiffer:
    """Incremental token -> text streaming that never emits half a
    character: only the newly stable text is emitted (a multi-token UTF-8
    sequence or subword merge stays buffered until complete). Only the
    tokens since the last stable emission are decoded again a push, so a
    long stream costs O(window) a token."""

    def __init__(self, tok) -> None:
        self._tok = tok
        self._ids: list[int] = []
        self._prefix = 0  # window start: ids before it are fully emitted
        self._read = 0    # ids[_prefix:_read] gave the last stable text

    def push(self, token: int) -> str:
        self._ids.append(int(token))
        stable = self._tok.decode(self._ids[self._prefix:self._read])
        full = self._tok.decode(self._ids[self._prefix:])
        # a trailing replacement character is a partial multi-byte
        # sequence: hold it back, the next token may complete it
        if full.endswith("�") or len(full) <= len(stable) \
                or not full.startswith(stable):
            return ""
        self._prefix = self._read
        self._read = len(self._ids)
        return full[len(stable):]

    def flush(self) -> str:
        stable = self._tok.decode(self._ids[self._prefix:self._read])
        full = self._tok.decode(self._ids[self._prefix:])
        if full.startswith(stable):
            return full[len(stable):]
        return ""  # a non-monotonic decode: all emitted already, best effort


def _render_chat(tokenizer, messages: list) -> list[int]:
    """Messages -> prompt ids: the HF tokenizer's chat template when it
    has one (the format the model was trained on), else a role-tagged
    template ending in an assistant header."""
    for m in messages:
        if not isinstance(m, dict) or not isinstance(m.get("role"), str) \
                or not isinstance(m.get("content"), str):
            raise ValueError(
                "each message needs string 'role' and 'content' fields"
            )
    hf = getattr(tokenizer, "_tok", None)
    if hf is not None and getattr(hf, "chat_template", None):
        ids = hf.apply_chat_template(messages, add_generation_prompt=True,
                                     tokenize=True)
        if isinstance(ids, dict):  # a BatchEncoding in newer transformers
            ids = ids["input_ids"]
        return list(ids)
    text = "".join(
        f"<|{m['role']}|>\n{m['content']}\n" for m in messages
    ) + "<|assistant|>\n"
    return tokenizer.encode(text)


def _check_token_ids(ids: list, vocab: int) -> list[int]:
    """One vocabulary rule for prompts and embedding inputs (``_is_ids``
    lists): an id outside it is refused (an embedding gather would read
    a wrong row)."""
    for t in ids:
        if not 0 <= t < vocab:
            raise ValueError(f"token id {t} outside vocab [0, {vocab})")
    return list(ids)


def oai_error(handler, message: str, status: int, code: "str | None" = None,
              extra: "dict | None" = None) -> None:
    """OpenAI's error envelope. ``type`` keys the SDKs' retry logic: a
    5xx (engine dead) is a retryable ``server_error``, every 4xx an
    ``invalid_request_error``. ``extra`` merges structured fields
    (``request_too_large``'s ``prompt_tokens``, ``max_new``, ``limit``)."""
    err_type = "server_error" if status >= 500 else "invalid_request_error"
    err: dict = {"message": message, "type": err_type, "code": code}
    if extra:
        err.update(extra)
    handler._json(status, {"error": err})


def oai_overloaded(handler, message: str, reason: str,
                   retry_after: int) -> None:
    """Scheduler overload: 429 with ``Retry-After`` and the retryable
    ``rate_limit_error`` envelope; ``code`` names the valve that fired."""
    handler._json(
        429, {"error": {"message": message, "type": "rate_limit_error",
                        "code": reason, "retry_after": int(retry_after)}},
        headers={"Retry-After": str(int(retry_after))})


class OpenAIRoutes:
    """The handlers, bound to an ``InferenceServer`` (its engine,
    tokenizer, embedder and scorer). Each takes the request's handler."""

    def __init__(self, server) -> None:
        self._server = server

    # --- request parsing -------------------------------------------------

    def _vocab(self) -> int:
        return self._server.engine.cb.cfg.vocab_size

    def _prompt_ids(self, body: dict) -> list[int]:
        prompt = body.get("prompt")
        if isinstance(prompt, str) and prompt:
            if self._server.tokenizer is None:
                raise ValueError(
                    "string prompts need a tokenizer on this server; "
                    "send a token-id list"
                )
            return self._server.tokenizer.encode(prompt)
        if _is_ids(prompt):
            return _check_token_ids(prompt, self._vocab())
        raise ValueError(
            "prompt must be a non-empty string or list of token ids "
            "(batched prompt lists are not supported)"
        )

    def _common(self, body: dict, allow_zero_max_tokens: bool = False) -> dict:
        """Fields both endpoints share, validated. ``max_new`` is None when
        max_tokens was omitted: each endpoint applies its own default.
        ``allow_zero_max_tokens`` admits 0 for echo scoring."""
        timeline = body.get("timeline", False)
        if not isinstance(timeline, bool):
            raise ValueError("timeline must be a boolean")
        n = int(body.get("n", 1))
        if not 1 <= n <= MAX_N:
            raise ValueError(f"n must be in [1, {MAX_N}]")
        stream = bool(body.get("stream", False))
        if stream and n > 1:
            raise ValueError("streaming supports n=1 only")
        max_new = body.get("max_tokens")
        if max_new is not None:
            max_new = int(max_new)
            floor = 0 if allow_zero_max_tokens else 1
            if max_new < floor:
                raise ValueError(f"max_tokens must be >= {floor}")
        stop = body.get("stop")
        stop_lists: list[list[int]] = []
        if stop is not None:
            if isinstance(stop, str):
                stop = [stop]
            if isinstance(stop, list) and len(stop) > 4:
                raise ValueError("stop supports at most 4 sequences")
            stop_lists = encode_stop_strings(self._server.tokenizer, stop,
                                             field="stop")
        sampler = None
        if "temperature" in body or "top_p" in body:
            sampler = Sampler(temperature=float(body.get("temperature", 1.0)),
                              top_p=float(body.get("top_p", 1.0)))
        logit_bias = _parse_logit_bias(body.get("logit_bias"))
        # validated BEFORE the per-choice (seed + i) % 2**31 derivation
        seed = ContinuousBatcher.validate_seed(body.get("seed"))
        ContinuousBatcher.validate_sched(body.get("tenant"),
                                         body.get("priority"),
                                         body.get("deadline_ms"))
        # "model" routes: the base model's id (or absent) -> the base, a
        # live adapter's name -> that adapter, anything else OpenAI's
        # model_not_found
        model = str(body.get("model") or MODEL_ID)
        adapter = -1
        if model != MODEL_ID:
            try:
                adapter = self._server.resolve_adapter(model)
            except ValueError:
                raise _ModelNotFound(model) from None
        return {
            "n": n, "stream": stream, "max_new": max_new,
            "stop": stop_lists, "sampler": sampler, "model": model,
            "adapter": adapter,
            "logit_bias": logit_bias, "seed": seed,
            "tenant": body.get("tenant"), "priority": body.get("priority"),
            "deadline_ms": body.get("deadline_ms"), "timeline": timeline,
        }

    def _budget(self, c: dict, prompt: list[int],
                default: "int | None") -> None:
        """An absent max_tokens: the endpoint's default, or (chat) the
        slot's remaining budget for this prompt."""
        if c["max_new"] is not None:
            return
        if default is not None:
            c["max_new"] = default
            return
        c["max_new"] = max(1, self._server.engine.cb.max_len - len(prompt))

    @staticmethod
    def _read(handler) -> dict:
        body = handler.read_json()
        if not isinstance(body, dict):
            raise ValueError("body must be a JSON object")
        return body

    @staticmethod
    def _finish_reason(n_out: int, max_new: int) -> str:
        # the engine retires on EOS, a stop or a cancel, or on its budget,
        # the one case that fills it exactly
        return "length" if n_out >= max_new else "stop"

    def _decode(self, ids: list[int]) -> str:
        tok = self._server.tokenizer
        return "" if tok is None else tok.decode(ids)

    # --- endpoints -------------------------------------------------------

    def models(self, handler) -> None:
        # an unregistered adapter's tombstone renders "": its index stays
        # burned, its name is not listed
        ids = (MODEL_ID,) + tuple(n for n in self._server.adapter_names if n)
        handler._json(200, {
            "object": "list",
            "data": [{"id": mid, "object": "model", "created": 0,
                      "owned_by": "tpu-device-plugin"} for mid in ids],
        })

    def embeddings(self, handler) -> None:
        """Input: a string, a list of strings, a token-id list or a list
        of token-id lists; the base model only."""
        embedder = self._server.embedder
        if embedder is None:
            oai_error(handler, "embeddings are not enabled on this server "
                      "(--embeddings)", 400)
            return
        try:
            body = self._read(handler)
            model = str(body.get("model") or MODEL_ID)
            if model != MODEL_ID:
                raise _ModelNotFound(model)
            inputs = self._embedding_inputs(body.get("input"))
            if len(inputs) > MAX_EMBED_INPUTS:
                raise ValueError(f"at most {MAX_EMBED_INPUTS} inputs per "
                                 f"request (got {len(inputs)})")
            cap = embedder.buckets[-1]
            for i, ids in enumerate(inputs):
                # the whole request is refused before any forward runs
                if len(ids) > cap:
                    raise ValueError(
                        f"input {i} has {len(ids)} tokens; the embedding "
                        f"bucket cap is {cap}"
                    )
        except _ModelNotFound as e:
            oai_error(handler, str(e), 404, code="model_not_found")
            return
        except (json.JSONDecodeError, TypeError, ValueError) as e:
            oai_error(handler, str(e), 400)
            return
        vecs = [embedder.embed(ids) for ids in inputs]
        n_tokens = sum(len(i) for i in inputs)
        handler._json(200, {
            "object": "list",
            "model": model,
            "data": [{"object": "embedding", "index": i,
                      "embedding": [float(x) for x in v]}
                     for i, v in enumerate(vecs)],
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        })

    def _embedding_inputs(self, raw) -> list[list[int]]:
        tok = self._server.tokenizer
        vocab = self._vocab()

        def encode(s: str) -> list[int]:
            if tok is None:
                raise ValueError("string inputs need a tokenizer on this "
                                 "server; send token-id lists")
            return tok.encode(s)

        if isinstance(raw, str) and raw:
            return [encode(raw)]
        if isinstance(raw, list) and raw:
            if all(isinstance(x, str) and x for x in raw):
                return [encode(s) for s in raw]
            if _is_ids(raw):
                return [_check_token_ids(raw, vocab)]
            if all(_is_ids(x) for x in raw):
                return [_check_token_ids(x, vocab) for x in raw]
        raise ValueError(
            "input must be a non-empty string, list of strings, token-id "
            "list, or list of token-id lists"
        )

    def completions(self, handler) -> None:
        try:
            body = self._read(handler)
            echo = bool(body.get("echo", False))
            c = self._common(body, allow_zero_max_tokens=echo)
            prompt = self._prompt_ids(body)
            lp = body.get("logprobs")
            want_logprobs = lp is not None and lp is not False  # 0 counts
            # OpenAI's range on both paths (the scorer computes TOP_K = 5)
            if want_logprobs and not 0 <= int(lp) <= 5:
                raise ValueError("logprobs must be between 0 and 5")
            best_of = body.get("best_of")
            if best_of is not None:
                best_of = int(best_of)
                if not c["n"] <= best_of <= MAX_N:
                    raise ValueError(
                        f"best_of must be >= n and <= {MAX_N} (each "
                        "candidate occupies a decode slot)")
                if c["stream"] and best_of > c["n"]:
                    raise ValueError("streaming requires best_of == n")
                if echo:
                    raise ValueError("echo does not support best_of")
                c["best_of"] = best_of
            if echo:
                self._check_echo(c, prompt)
            else:
                self._budget(c, prompt, default=16)  # OpenAI's legacy default
        except _ModelNotFound as e:
            oai_error(handler, str(e), 404, code="model_not_found")
            return
        except (json.JSONDecodeError, TypeError, ValueError) as e:
            oai_error(handler, str(e), 400)
            return
        if echo:
            self._echo_score(handler, prompt, want_logprobs,
                             int(lp) if want_logprobs else 0)
            return
        self._respond(handler, prompt, c, want_logprobs,
                      object_name="text_completion", id_prefix="cmpl",
                      chat=False)

    def _check_echo(self, c: dict, prompt: list[int]) -> None:
        """echo: the lm-eval loglikelihood contract (the prompt echoed with
        its own teacher-forced logprobs, nothing generated)."""
        if self._server.scorer is None:
            raise ValueError("echo requires prompt scoring; start the "
                             "server with --scoring")
        if c["max_new"] not in (None, 0):
            raise ValueError("echo is supported only with max_tokens 0 "
                             "(prompt scoring)")
        if c["n"] != 1:
            raise ValueError("echo supports n == 1 only")
        if c["stream"]:
            raise ValueError("echo does not support streaming")
        if c["adapter"] != -1:
            raise ValueError("echo scores the base model only")
        # the scorer's cap bounds every echo request, logprobs or not
        cap = self._server.scorer.max_len
        if len(prompt) > cap:
            raise ValueError(f"prompt of {len(prompt)} tokens exceeds the "
                             f"scoring cap {cap}")

    def _echo_score(self, handler, prompt: list[int], want_logprobs: bool,
                    top_n: int) -> None:
        tok = self._server.tokenizer
        lp_payload = None
        if want_logprobs:
            try:
                lps, top_lps, top_ids = self._server.scorer.score_full(prompt)
            except ValueError as e:  # the cap: a client-size mistake
                oai_error(handler, str(e), 400)
                return
            # per-token strings through the streaming detokenizer: an
            # incomplete character contributes "" and the token completing
            # it carries it, so ''.join(tokens) is the returned text and
            # the offsets stay monotone
            tokens, offsets = [], []
            pos = 0
            differ = _TextDiffer(tok) if tok is not None else None
            for t in prompt:
                piece = differ.push(t) if differ is not None else str(t)
                offsets.append(pos)
                tokens.append(piece)
                pos += len(piece)
            tail = differ.flush() if differ is not None else ""
            if tail and tokens:
                tokens[-1] += tail
            top_payload = None
            if top_n > 0:
                def tstr(tid: int) -> str:
                    return tok.decode([tid]) if tok is not None else str(tid)

                # the top-N alternatives a position (index 0 null, as in
                # token_logprobs). Keyed by token STRING: ids decoding
                # alike merge, and best-first setdefault keeps the likelier
                top_payload = [None]
                for i in range(1, len(prompt)):
                    entry: dict[str, float] = {}
                    for j in range(top_n):
                        entry.setdefault(tstr(int(top_ids[i, j])),
                                         float(top_lps[i, j]))
                    top_payload.append(entry)
            lp_payload = {"tokens": tokens, "token_logprobs": lps,
                          "top_logprobs": top_payload,
                          "text_offset": offsets}
        if tok is None:
            text = ""  # a token-ids-only server, as on the generate path
        elif lp_payload is not None:
            text = "".join(lp_payload["tokens"])  # exact by construction
        else:
            text = tok.decode(prompt)
        handler._json(200, {
            "id": f"cmpl-echo-{uuid.uuid4().hex[:16]}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": MODEL_ID,
            "choices": [{"index": 0, "text": text, "finish_reason": "length",
                         "logprobs": lp_payload}],
            "usage": {"prompt_tokens": len(prompt), "completion_tokens": 0,
                      "total_tokens": len(prompt)},
        })

    def chat_completions(self, handler) -> None:
        try:
            body = self._read(handler)
            c = self._common(body)
            if self._server.tokenizer is None:
                raise ValueError(
                    "chat completions need a tokenizer on this server"
                )
            # the newer field name wins over max_tokens; null means absent
            mct = body.get("max_completion_tokens")
            if mct is not None:
                mct = int(mct)
                if mct < 1:
                    raise ValueError("max_completion_tokens must be >= 1")
                c["max_new"] = mct
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                raise ValueError("messages must be a non-empty list")
            prompt = _render_chat(self._server.tokenizer, messages)
            self._budget(c, prompt, default=None)  # chat: the slot budget
            want_logprobs = bool(body.get("logprobs", False))
        except _ModelNotFound as e:
            oai_error(handler, str(e), 404, code="model_not_found")
            return
        except (json.JSONDecodeError, TypeError, ValueError) as e:
            oai_error(handler, str(e), 400)
            return
        self._respond(handler, prompt, c, want_logprobs,
                      object_name="chat.completion", id_prefix="chatcmpl",
                      chat=True)

    def _respond(self, handler, prompt: list[int], c: dict,
                 want_logprobs: bool, object_name: str, id_prefix: str,
                 chat: bool) -> None:
        engine = self._server.engine
        try:
            # best_of > n samples the extras; the ranking keeps n
            subs = submit_choices(
                engine, prompt, c.get("best_of") or c["n"], c["seed"],
                max_new=c["max_new"], stop=c["stop"], sampler=c["sampler"],
                logit_bias=c["logit_bias"], tenant=c["tenant"],
                priority=c["priority"], deadline_ms=c["deadline_ms"],
                adapter=c["adapter"])
        except RequestTooLargeError as e:
            oai_error(handler, str(e), 422, code="request_too_large",
                      extra=e.body())
            return
        except ValueError as e:  # capacity, bucket, sampler validation
            oai_error(handler, str(e), 422)
            return
        except SchedulerOverloadError as e:  # queue full: 429
            engine.cb.scheduler.count_sync_rejection(engine.cb)
            oai_overloaded(handler, str(e), e.reason, e.retry_after)
            return
        except RuntimeError as e:  # engine dead
            oai_error(handler, str(e), 503)
            return
        rid = subs[0][0]
        oai_id = f"{id_prefix}-{rid}"
        created = int(time.time())
        if c["stream"]:
            self._stream(handler, subs[0][1], oai_id, created, c, chat, rid,
                         want_logprobs, object_name)
            return
        drained = [drain_queue(q) for _, q in subs]
        err = next((e for _, _, e in drained if e is not None), None)
        if err is not None:
            # engine death mid-request: a retryable server_error, never a
            # 200 with truncated text
            oai_error(handler, err.message, 503, code=err.code)
            return
        cands = []
        completion_tokens = 0  # usage bills everything sampled (best_of too)
        for toks, lps, _ in drained:
            kept = trim_stop_suffix(toks, c["stop"])  # never the stop itself
            completion_tokens += len(kept)
            finish = ("stop" if len(kept) < len(toks)
                      else self._finish_reason(len(toks), c["max_new"]))
            cands.append((kept, lps[:len(kept)], finish))
        if len(cands) > c["n"]:
            # best_of: highest mean token logprob, stable on ties; an empty
            # (fully trimmed) candidate has no mean and ranks last
            cands.sort(key=lambda t: -(sum(t[1]) / len(t[1])) if t[1]
                       else float("inf"))
            cands = cands[:c["n"]]
        choices = []
        for i, (kept, lps, finish) in enumerate(cands):
            text = self._decode(kept)
            choice: dict = {"index": i, "finish_reason": finish}
            if chat:
                choice["message"] = {"role": "assistant", "content": text}
                if want_logprobs:
                    choice["logprobs"] = {"content": [
                        {"token": self._decode([t]), "logprob": lp}
                        for t, lp in zip(kept, lps)]}
            else:
                choice["text"] = text
                if want_logprobs:
                    choice["logprobs"] = {
                        "tokens": [self._decode([t]) for t in kept],
                        "token_logprobs": lps,
                    }
            choices.append(choice)
        infos = [engine.pop_request_info(eid) for eid, _ in subs]
        reject = next((i["reject_reason"] for i in infos
                       if i.get("reject_reason")), None)
        if reject is not None and completion_tokens == 0:
            # rejected while queued before a single token: overload
            oai_overloaded(
                handler, "request rejected under overload before admission",
                reject, max((i.get("retry_after", 1) for i in infos),
                            default=1))
            return
        envelope = {
            "id": oai_id,
            "object": object_name,
            "created": created,
            "model": c["model"],
            "choices": choices,
            "usage": {
                "prompt_tokens": len(prompt),
                # prefix-cache reuse: the best of the choices'
                "prompt_tokens_details": {"cached_tokens": max(
                    (i.get("cached_tokens", 0) for i in infos), default=0)},
                "completion_tokens": completion_tokens,
                "total_tokens": len(prompt) + completion_tokens,
            },
        }
        if c["timeline"]:
            # the extension field: the primary choice's timeline
            envelope["timeline"] = infos[0].get("timeline")
        handler._json(200, envelope)

    def _stream(self, handler, q, oai_id: str, created: int, c: dict,
                chat: bool, rid: int, want_logprobs: bool,
                object_name: str) -> None:
        chunk_object = "chat.completion.chunk" if chat else object_name
        handler.start_sse()

        def event(choice: dict) -> dict:
            return {"id": oai_id, "object": chunk_object, "created": created,
                    "model": c["model"], "choices": [choice]}

        def chunk(text: str, lp: "float | None",
                  finish: "str | None") -> dict:
            choice: dict = {"index": 0, "finish_reason": finish}
            if chat:
                choice["delta"] = {"content": text} if finish is None else {}
                if lp is not None:
                    choice["logprobs"] = {"content": [{"token": text,
                                                       "logprob": lp}]}
            else:
                choice["text"] = text
                if lp is not None:
                    choice["logprobs"] = {"tokens": [text],
                                          "token_logprobs": [lp]}
            return event(choice)

        tok = self._server.tokenizer
        differ = _TextDiffer(tok) if tok is not None else None
        # a stop never streams: hold back the last max(stop) tokens (a
        # suffix match spans at most that many)
        hold = max((len(s) for s in c["stop"]), default=0)
        pending: list[tuple[int, float]] = []
        all_out: list[int] = []

        def release(token: int, lp: float) -> None:
            # a token-ids-only server streams "" (ids belong to the native
            # API), with the logprob when asked
            text = differ.push(token) if differ is not None else ""
            if text or want_logprobs:
                handler.sse(chunk(text, lp if want_logprobs else None, None))

        try:
            if chat:
                handler.sse(event({"index": 0, "finish_reason": None,
                                   "delta": {"role": "assistant"}}))
            while True:
                item = q.get()
                if isinstance(item, StreamError):
                    # an abnormal close: the stream-error envelope, then
                    # [DONE], never a clean finish_reason
                    handler.sse({"error": {"message": item.message,
                                           "type": "server_error",
                                           "code": item.code}})
                    handler.sse("[DONE]")
                    return
                if item is not None:
                    all_out.append(item[0])
                    pending.append(item)
                    while len(pending) > hold:
                        release(*pending.pop(0))
                    continue
                info = self._server.engine.pop_request_info(rid)
                if not all_out:
                    if info.get("reject_reason"):
                        # rejected while queued, zero tokens, on a stream
                        # already 200: the overload rides an error event
                        handler.sse({"error": {
                            "message": "request rejected under overload "
                                       "before admission",
                            "type": "rate_limit_error",
                            "code": info["reject_reason"],
                            "retry_after": info.get("retry_after", 1)}})
                        handler.sse("[DONE]")
                        return
                kept = trim_stop_suffix(all_out, c["stop"])
                drop = len(all_out) - len(kept)
                for token, lp in pending[:len(pending) - drop]:
                    release(token, lp)
                tail = differ.flush() if differ is not None else ""
                if tail:
                    handler.sse(chunk(tail, None, None))
                finish = ("stop" if drop else
                          self._finish_reason(len(all_out), c["max_new"]))
                handler.sse(chunk("", None, finish))
                handler.sse("[DONE]")
                return
        except (BrokenPipeError, ConnectionResetError):
            self._server.engine.cancel(rid)  # the client went away
