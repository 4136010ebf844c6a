"""Tokenizer seam for the inference server: text in and out.

Port of ``k8s_gpu_device_plugin_tpu/serving/tokenizer.py``. The engine
sees token ids only; the HTTP front translates text at its edge through
any object with ``encode(str) -> list[int]`` and ``decode(list[int]) ->
str``:

- :class:`HFTokenizer` wraps a HuggingFace tokenizer loaded from a LOCAL
  directory (``local_files_only=True``: nothing is downloaded).
  ``transformers`` is imported when one is built, never at import time.
- :class:`ByteTokenizer` needs nothing: UTF-8 bytes as ids, a lossless
  round trip for any text, for any model whose vocabulary holds 256 ids
  (the companion of the random-weights server).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class TokenizerSeam(Protocol):
    def encode(self, text: str) -> list[int]: ...

    def decode(self, ids: list[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes as token ids (vocabulary 256). Ids >= 256 (a model
    sampling outside the byte range, as random weights do constantly)
    decode as U+FFFD, one per id, never clamped onto a real byte."""

    vocab_size = 256
    eos_id: "int | None" = None

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    # byte-level: no special tokens, so stop strings encode the same way
    encode_plain = encode

    def decode(self, ids: list[int]) -> str:
        out: list[str] = []
        run: list[int] = []  # contiguous valid bytes, decoded together
        for i in ids:
            if 0 <= int(i) < 256:
                run.append(int(i))
                continue
            out.append(bytes(run).decode("utf-8", errors="replace"))
            run = []
            out.append("�")
        out.append(bytes(run).decode("utf-8", errors="replace"))
        return "".join(out)


class HFTokenizer:
    """A HuggingFace tokenizer from a local directory that already holds
    its files (no hub download)."""

    def __init__(self, path: str) -> None:
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise RuntimeError(
                "an HF tokenizer directory needs the 'transformers' "
                "package, which is not installed; use --tokenizer byte"
            ) from e
        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.eos_id: "int | None" = self._tok.eos_token_id

    def encode(self, text: str) -> list[int]:
        return list(self._tok.encode(text, add_special_tokens=True))

    def encode_plain(self, text: str) -> list[int]:
        """No special tokens: stop strings must match a run of GENERATED
        output, and a prepended BOS would never match."""
        return list(self._tok.encode(text, add_special_tokens=False))

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def load_tokenizer(spec: str) -> "TokenizerSeam | None":
    """The ``--tokenizer`` value: "" -> None (token ids only), "byte" ->
    :class:`ByteTokenizer`, anything else -> a local HF directory."""
    if not spec:
        return None
    if spec == "byte":
        return ByteTokenizer()
    return HFTokenizer(spec)


def encode_stop_strings(tokenizer, strings, field: str = "stop") -> list:
    """Stop strings -> token-id lists, one rule for the native and OpenAI
    handlers: no special tokens, and a loud failure when an entry encodes
    to nothing. Exact for byte-level tokenizers; best-effort across
    subword merge boundaries (standalone encoding may merge otherwise
    than in context)."""
    if tokenizer is None:
        raise ValueError(f"{field} requires a tokenizer on this server")
    if not isinstance(strings, list) or not all(
        isinstance(s, str) and s for s in strings
    ):
        raise ValueError(f"{field} must be a list of non-empty strings")
    enc = getattr(tokenizer, "encode_plain", tokenizer.encode)
    out: list[list[int]] = []
    for s in strings:
        ids = enc(s)
        if not ids:
            # dropping it silently would leave the client believing the
            # stop is armed
            raise ValueError(f"{field} entry {s!r} encodes to no tokens")
        out.append(list(ids))
    return out


def trim_stop_suffix(tokens: list, stop: list) -> list:
    """Drop a matched stop sequence from the end of ``tokens`` (OpenAI
    semantics: returned text never holds the stop; the native API keeps
    it, like EOS). The SHORTEST matching suffix wins: the engine halts on
    the first suffix that completes, so with stop ["ab", "b"] and output
    "... a b" it fired on "b", and the "a" was generated."""
    best: "int | None" = None
    for st in stop:
        if len(st) <= len(tokens) and list(tokens[-len(st):]) == list(st):
            if best is None or len(st) < best:
                best = len(st)
    return list(tokens[:-best]) if best is not None else list(tokens)
