"""Token samplers for serving decode: per-row knobs as tensors.

Port of ``k8s_gpu_device_plugin_tpu/models/sampling.py`` (``Sampler``,
``sampler_knobs``, ``sample_logits_dyn``, ``sample_and_mark_dyn``,
``token_logprob``). The order is the reference's: a per-row logit bias
added to the raw logits, then repetition penalty, temperature, top-k and
top-p; greedy rows (temperature 0) take the argmax of the biased,
penalised logits.

Random draws cannot reproduce JAX's (``fold_in(key(seed), i)``), so the
port pins its own rule: a draw is an argmax over logits plus Gumbel
noise. An unseeded row's noise comes from the batcher's shared
``torch.Generator``. A seeded row's noise is a stateless function of
(seed, draw index, vocabulary index), computed with integer tensor ops
on the row's device (:func:`counter_gumbel`), so its stream depends on
its seed and its own logits only, never on its neighbours, and a CUDA
graph replays it without any generator state.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_NEG = -1e30


@dataclass(frozen=True)
class Sampler:
    """Static sampling config. ``temperature == 0`` is exact greedy;
    ``top_k == 0`` / ``top_p >= 1`` disable those filters;
    ``repetition_penalty`` (CTRL rule, 1.0 = off) applies before them
    and also under greedy decoding."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0

    def __post_init__(self) -> None:
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.repetition_penalty < 1.0:
            raise ValueError(
                f"repetition_penalty must be >= 1, got "
                f"{self.repetition_penalty}"
            )

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


def sampler_knobs(sampler: Sampler) -> tuple[float, float, float, float]:
    """Sampler -> the (temperature, top_k, top_p, repetition_penalty)
    row the per-row path consumes (top_k rides as f32)."""
    return (sampler.temperature, float(sampler.top_k), sampler.top_p,
            sampler.repetition_penalty)


def init_presence(prompt: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """(B, P) prompt -> (B, V) bool mask of tokens already in context."""
    presence = torch.zeros((prompt.shape[0], vocab_size), dtype=torch.bool,
                           device=prompt.device)
    presence.scatter_(1, prompt.long(), True)
    return presence


def _gumbel(shape, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit
    constant, in 16-bit halves so that no product leaves int64."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer (a bijection of [0, 2^32)), in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def counter_gumbel(seeds: torch.Tensor, draws: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """(B,) seeds and (B,) draw indices -> (B, V) f32 Gumbel noise, a
    pure function of (seed, draw, vocabulary index): the seeded rows'
    noise. Each entry hashes its three integers to 32 bits, keeps the top
    24 as a uniform in (0, 1) and takes -log(-log(u)). Integer ops only
    up to the uniform, so CPU and CUDA draw the same uniforms."""
    row = _fmix32(_mul32(seeds.long() & _MASK32, 0x9E3779B1)
                  ^ (draws.long() & _MASK32))
    row = _fmix32(row ^ 0x5BD1E995)
    col = _mul32(torch.arange(vocab, dtype=torch.int64,
                              device=seeds.device), 0x27D4EB2F)
    h = _fmix32(row[:, None] ^ col[None, :])
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_logits_dyn(
    logits: torch.Tensor,      # (B, V)
    knobs: torch.Tensor,       # (B, 4) f32: temp, top_k, top_p, rep_penalty
    presence: torch.Tensor,    # (B, V) bool
    generator: "torch.Generator | None" = None,
    bias: "torch.Tensor | None" = None,   # (B, V) f32 per-row logit bias
    seeds: "torch.Tensor | None" = None,  # (B,) int seed, -1 = unseeded
    draws: "torch.Tensor | None" = None,  # (B,) int draw index
) -> torch.Tensor:
    """Per-row knobs -> (B,) int64 tokens. ``bias`` is added to the raw
    logits before the penalty and every filter (OpenAI ``logit_bias``:
    -100 bans a token, +100 forces it); a zero row leaves the f32 logits
    as they are. ``generator`` feeds the rows without a seed: it draws
    one (B, V) block per call, greedy or not, whatever the seeds say. A
    row with ``seeds[i] >= 0`` takes :func:`counter_gumbel` noise at draw
    ``draws[i]`` (0 when ``draws`` is None: a request's first token)."""
    logits = logits.float()
    if bias is not None:
        logits = logits + bias
    temp, top_k, top_p, rep = knobs.float().unbind(-1)
    pen = rep[:, None]
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    logits = torch.where(presence, penalized, logits)
    greedy_tok = logits.argmax(dim=-1)

    b, v = logits.shape
    neg = torch.full_like(logits, _NEG)
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    k = torch.clamp(top_k.long(), 0, v)
    sorted_k = torch.sort(scaled, dim=-1, descending=True).values
    kth = sorted_k.gather(-1, torch.clamp(k - 1, 0, v - 1)[:, None])
    use_k = (k > 0)[:, None]
    scaled = torch.where(use_k & (scaled < kth), neg, scaled)
    # the post-top-k sort is the pre-top-k sort with its tail masked
    sorted_p = torch.where(use_k & (sorted_k < kth), neg, sorted_k)
    probs = torch.softmax(sorted_p, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs  # exclusive (nucleus rule)
    pth = torch.where(cum < top_p[:, None], sorted_p,
                      torch.full_like(sorted_p, float("inf")))
    pth = pth.min(dim=-1, keepdim=True).values
    scaled = torch.where((top_p < 1.0)[:, None] & (scaled < pth), neg, scaled)

    noise = _gumbel((b, v), generator, logits.device)
    if seeds is not None:
        if draws is None:
            draws = torch.zeros_like(seeds)
        noise = torch.where((seeds >= 0)[:, None],
                            counter_gumbel(seeds, draws, v), noise)
    sampled = (scaled + noise).argmax(dim=-1)
    return torch.where(temp == 0.0, greedy_tok, sampled)


def sample_and_mark_dyn(
    logits: torch.Tensor, knobs: torch.Tensor, presence: torch.Tensor,
    generator: "torch.Generator | None" = None,
    bias: "torch.Tensor | None" = None,
    seeds: "torch.Tensor | None" = None,
    draws: "torch.Tensor | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sample_logits_dyn`, plus the presence mask with each row's
    token marked (a new tensor; ``presence`` is not modified)."""
    tok = sample_logits_dyn(logits, knobs, presence, generator, bias, seeds,
                            draws)
    # a scatter of a Python scalar: no host tensor to copy, so it can be
    # captured in a CUDA graph
    return tok, presence.scatter(1, tok[:, None], True)


def token_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """log P(tok) under the RAW model distribution (f32 log-softmax of
    the unfiltered, unbiased logits), independent of every sampler knob
    and of the logit bias."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, tok.long()[..., None])[..., 0]
