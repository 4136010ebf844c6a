"""Beam search over the KV-cache decode path.

Port of ``k8s_gpu_device_plugin_tpu/models/beam.py``. The cache is
allocated at ``beam`` batch rows up front; every step is one T=1 cached
forward over all beams (on the card, the ragged-paged kernel's split
decode route at B = beam), a (beam * V) top-k, and a batch-axis gather
that reorders the cache and token buffer by each survivor's parent beam.
Scores are exact cumulative log-probabilities (log-softmax in f32); with
a fixed ``max_new`` every hypothesis has the same length, so no length
normalization is applied.

Ties resolve as the reference's ``lax.top_k`` resolves them: the lower
flat index first (:func:`_top_k`, a stable descending sort).

Guarantees pinned by tests: ``beam=1`` emits exactly the greedy decode;
each returned score equals the sequence's recomputed log-probability
under the full-context forward; and for ``max_new=2`` with
``beam == vocab`` the search is exhaustive, matching brute force.
"""

from __future__ import annotations

import torch

from k8s_gpu_device_plugin_torch.models.generate import (
    KVCache,
    _forward_cached,
    prefill,
)
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the 1-D ``x`` in descending order and
    their indices, equal entries in ascending index order (``lax.top_k``'s
    order; ``torch.topk`` promises none)."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def _gather_beams(cache: KVCache, parent: torch.Tensor) -> KVCache:
    """Reorder the beam axis (axis 1 of every ``(L, beam, S, Hkv, ...)``
    plane) by ``parent``."""

    def take(x):
        return None if x is None else x.index_select(1, parent)

    return KVCache(k=take(cache.k), v=take(cache.v),
                   k_scale=take(cache.k_scale), v_scale=take(cache.v_scale))


def beam_search(
    params: dict,
    prompt: torch.Tensor,
    cfg: LlamaConfig,
    max_new: int,
    beam: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """prompt (1, P) -> (sequences (beam, max_new), scores (beam,)).

    Sequences are sorted by score descending (row 0 is the best
    hypothesis); scores are cumulative f32 token log-probabilities. Runs
    where ``prompt`` and ``params`` live.
    """
    b, p = prompt.shape
    if b != 1:
        raise NotImplementedError("beam search decodes one prompt at a time")
    if beam < 1:
        raise ValueError(f"beam must be >= 1, got {beam}")
    if beam > cfg.vocab_size:
        raise ValueError(
            f"beam ({beam}) cannot exceed vocab_size ({cfg.vocab_size}): "
            "there are only vocab_size distinct continuations per step"
        )
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    v = cfg.vocab_size
    device = prompt.device

    # prefill ONCE at batch 1 (all beams share the prompt — a beam-row
    # prefill would pay beam x the prompt FLOPs for identical results),
    # then replicate the filled K/V rows (and scale planes) across beams
    cache = KVCache.init(cfg, 1, p + max_new, device)
    logits = prefill(params, prompt, cache, cfg)
    cache = _gather_beams(cache, torch.zeros(beam, dtype=torch.long,
                                             device=device))
    logp = torch.log_softmax(logits.float(), dim=-1)

    # first token: top-beam continuations of the single real hypothesis
    scores, first = _top_k(logp[0], beam)
    buf = torch.zeros((beam, max_new), dtype=torch.long, device=device)
    buf[:, 0] = first
    last = first
    for i in range(p, p + max_new - 1):
        logits = _forward_cached(params, last[:, None], cache, i, cfg)
        lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        cand = scores[:, None] + lp                     # (beam, V)
        scores, flat_idx = _top_k(cand.reshape(-1), beam)
        parent = flat_idx // v
        last = flat_idx % v
        buf = buf.index_select(0, parent)
        buf[:, i + 1 - p] = last
        cache = _gather_beams(cache, parent)
    return buf, scores
