"""Token samplers for serving decode: per-row knobs as tensors.

Port of ``k8s_gpu_device_plugin_tpu/models/sampling.py`` (``Sampler``,
``sampler_knobs``, ``sample_logits_dyn``, ``sample_and_mark_dyn``,
``token_logprob``). The filter order is the reference's: repetition
penalty, then temperature, then top-k, then top-p; greedy rows
(temperature 0) take the argmax of the penalised logits.

Random draws cannot reproduce JAX's (``fold_in(key(seed), i)``), so the
port pins its own rule: a draw is an argmax over logits plus Gumbel
noise, the noise of an unseeded row comes from the batcher's shared
``torch.Generator``, and a seeded request owns a generator of its own
whose i-th use is its i-th draw — its stream depends on its seed and
its own logits only, never on its neighbours.
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


def sample_logits_dyn(
    logits: torch.Tensor,      # (B, V)
    knobs: torch.Tensor,       # (B, 4) f32: temp, top_k, top_p, rep_penalty
    presence: torch.Tensor,    # (B, V) bool
    generator: "torch.Generator | None" = None,
    row_generators: "list[torch.Generator | None] | None" = None,
) -> torch.Tensor:
    """Per-row knobs -> (B,) int64 tokens. ``generator`` feeds the rows
    without a generator of their own; ``row_generators[i]`` (seeded
    requests) feeds row i alone. Every row draws once per call, greedy
    or not, so a generator's i-th draw is its row's i-th token."""
    logits = logits.float()
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
    for i, gen in enumerate(row_generators or ()):
        if gen is not None:
            noise[i] = _gumbel((v,), gen, logits.device)
    sampled = (scaled + noise).argmax(dim=-1)
    return torch.where(temp == 0.0, greedy_tok, sampled)


def sample_and_mark_dyn(
    logits: torch.Tensor, knobs: torch.Tensor, presence: torch.Tensor,
    generator: "torch.Generator | None" = None,
    row_generators: "list[torch.Generator | None] | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sample_logits_dyn`, plus the presence mask with each row's
    token marked (a new tensor; ``presence`` is not modified)."""
    tok = sample_logits_dyn(logits, knobs, presence, generator,
                            row_generators)
    marked = presence.clone()
    marked[torch.arange(tok.shape[0], device=tok.device), tok] = True
    return tok, marked


def token_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """log P(tok) under the RAW model distribution (f32 log-softmax of
    the unfiltered logits), independent of every sampler knob."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, tok.long()[..., None])[..., 0]
