"""Prompt scoring for the serving pod: teacher-forced token logprobs.

Port of ``k8s_gpu_device_plugin_tpu/serving/scoring.py``: the OpenAI
completions contract eval harnesses rely on (lm-eval's
``loglikelihood``): ``echo=true, max_tokens=0, logprobs=N`` returns the
PROMPT's own per-token logprobs, one teacher-forced forward and no
sampling, with the ``TOP_K`` likeliest alternatives at each position.

Two paths, one convention (``score_full``: row t is token t's score
under its prefix; row 0 has no context):

- **Short** (prompts up to the largest bucket): one non-cached forward
  (``models/llama.py::forward_with_aux``) over the prompt padded to its
  bucket. On a card its attention is the flash forward kernel (K2) at
  B 1, S the padded bucket (``serving/bucketed.py``'s K2 rule).
- **Long** (up to ``max_len``): chunks of ``chunk`` (512) rows through
  the cached forward (``models/generate.py::_forward_cached``) into a
  batch-1 dense ``KVCache`` of ``ceil(max_len / chunk) * chunk`` rows,
  teacher-forced across chunk boundaries. On a card each chunk reaches
  the ragged-paged kernel's chunk route (K1) at T 512, bases 0, 512, ...

Token t's logprob comes from the logits at t - 1. The f32 logits over a
128,256-token vocabulary are 0.5 MB a row, so the lm_head, the
log-softmax and the top-k run ``LOGIT_ROWS`` rows at a time, and only
over rows whose target is a real token. Not served with weight-only
quantized weights (the CLI refuses ``--scoring`` with ``--weightQuant``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from k8s_gpu_device_plugin_torch.models.batching import DEFAULT_PROMPT_BUCKETS
from k8s_gpu_device_plugin_torch.models.generate import (
    KVCache,
    _forward_cached,
)
from k8s_gpu_device_plugin_torch.models.llama import (
    LlamaConfig,
    forward_with_aux,
    head_weights,
)
from k8s_gpu_device_plugin_torch.models.quantized_serving import qhead_matmul
from k8s_gpu_device_plugin_torch.serving.bucketed import BucketedForward

TOP_K = 5        # OpenAI caps completions logprobs at 5 alternatives
LOGIT_ROWS = 128  # rows of f32 logits held at once


def _score_rows(logits_of, n_rows: int, targets: torch.Tensor):
    """Score ``n_rows`` positions: ``logits_of(r0, r1)`` gives the f32
    logits (r1 - r0, V) of rows r0:r1, row r predicting ``targets[r]``.
    Returns (scores (n,), top logprobs (n, K), top ids (n, K))."""
    if n_rows <= 0:  # a one-token prompt: nothing has context
        dev = targets.device
        return (torch.zeros(0, device=dev),
                torch.zeros((0, TOP_K), device=dev),
                torch.zeros((0, TOP_K), dtype=torch.int32, device=dev))
    scores, top_lps, top_ids = [], [], []
    for r0 in range(0, n_rows, LOGIT_ROWS):
        r1 = min(n_rows, r0 + LOGIT_ROWS)
        lp = torch.log_softmax(logits_of(r0, r1).float(), dim=-1)
        scores.append(lp.gather(1, targets[r0:r1, None])[:, 0])
        v, i = lp.topk(TOP_K, dim=-1)
        top_lps.append(v)
        top_ids.append(i.to(torch.int32))
        del lp
    return torch.cat(scores), torch.cat(top_lps), torch.cat(top_ids)


def _score_one(params, tokens: torch.Tensor, length: int, cfg: LlamaConfig,
               plain_attention: bool = False):
    """(P,) padded ids + real length n -> the scoring triple of rows
    1 .. n-1 (the scores of tokens 1 .. n-1, the alternatives at their
    positions); padding is never scored."""
    hidden, _ = forward_with_aux(params, tokens[None, :], cfg,
                                 return_hidden=True,
                                 plain_attention=plain_attention)
    head = head_weights(params, cfg)
    return _score_rows(
        lambda r0, r1: qhead_matmul(hidden[0, r0:r1], head, cfg.dtype),
        length - 1, tokens[1:length])


class Scorer(BucketedForward):
    """Bucketed, thread-safe prompt scorer over the serving weights (the
    discipline of ``serving/bucketed.py``). Prompts up to
    ``buckets[-1]`` take the short path, longer ones up to ``max_len``
    the chunked one; both run at construction. ``plain_attention`` runs
    the plain attention on any device (the comparison path)."""

    def __init__(self, params, cfg: LlamaConfig,
                 buckets: tuple[int, ...] = DEFAULT_PROMPT_BUCKETS,
                 max_len: int = 4096, chunk: int = 512,
                 warmup: bool = True, plain_attention: bool = False):
        # a cap below the largest bucket trims the buckets instead of
        # being raised silently: "longest scorable prompt" means it
        buckets = tuple(b for b in sorted(buckets) if b <= max_len)
        if not buckets:
            raise ValueError(
                f"max_len {max_len} is below the smallest scoring bucket"
            )
        self.max_len = max_len
        self.chunk = chunk
        self.plain_attention = plain_attention
        super().__init__(functools.partial(_score_one,
                                           plain_attention=plain_attention),
                         params, cfg, buckets, kind="scoring", warmup=warmup)

    def warmup(self) -> None:
        super().warmup()
        if self.max_len > self.buckets[-1]:
            with self.running():
                cache = KVCache.init(self.cfg, 1, self._cache_len(),
                                     self.device)
                z = torch.zeros((1, self.chunk), dtype=torch.int64,
                                device=self.device)
                _forward_cached(self.params, z, cache, 0, self.cfg,
                                plain_attention=self.plain_attention).cpu()

    def _cache_len(self) -> int:
        # one cache shape, shared by every long prompt whatever its length
        return -(-self.max_len // self.chunk) * self.chunk

    def score(self, ids: list[int]) -> "list[float | None]":
        """Per-token logprobs of ``ids``; index 0 is None (no context)."""
        return self.score_full(ids)[0]

    def score_full(self, ids: list[int]) -> tuple:
        """(per-token logprobs, top-K logprobs (n, K), top-K ids (n, K)).
        Row 0 of the top arrays is zero (no context): callers emit null
        there."""
        n = len(ids)
        if n > self.buckets[-1]:
            return self._score_long(ids)
        scores, top_lps, top_ids = self.dispatch(ids)
        return self._assemble(n, scores, top_lps, top_ids)

    @staticmethod
    def _assemble(n: int, scores, top_lps, top_ids) -> tuple:
        """Rows 1 .. n-1 of a path -> the ``score_full`` convention."""
        out_lps = np.zeros((n, TOP_K), np.float32)
        out_ids = np.zeros((n, TOP_K), np.int32)
        out_lps[1:] = top_lps.numpy()
        out_ids[1:] = top_ids.numpy()
        return ([None] + [float(v) for v in scores.numpy()], out_lps,
                out_ids)

    def _score_long(self, ids: list[int]) -> tuple:
        n = len(ids)
        if n > self.max_len:
            raise ValueError(
                f"input of {n} tokens exceeds the {self.kind} cap "
                f"{self.max_len}"
            )
        c_rows = self.chunk
        n_chunks = -(-n // c_rows)
        padded = list(ids) + [0] * (n_chunks * c_rows - n)
        parts = []
        with self.running():
            cache = KVCache.init(self.cfg, 1, self._cache_len(), self.device)
            toks = torch.tensor(padded, dtype=torch.int64, device=self.device)
            for c in range(n_chunks):
                base = c * c_rows
                logits = _forward_cached(
                    self.params, toks[None, base:base + c_rows], cache, base,
                    self.cfg, plain_attention=self.plain_attention)[0]
                # row i predicts token base + i + 1: score the real ones
                rows = min(c_rows, n - 1 - base)
                if rows > 0:
                    parts.append(_score_rows(
                        lambda r0, r1: logits[r0:r1], rows,
                        toks[base + 1:base + 1 + rows]))
                del logits
            scores, top_lps, top_ids = (torch.cat(x).cpu()
                                        for x in zip(*parts))
            del cache
        return self._assemble(n, scores, top_lps, top_ids)
