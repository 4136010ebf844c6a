"""Speculative decoding: a draft model proposes, the target verifies.

Port of ``k8s_gpu_device_plugin_tpu/models/speculative.py`` (``_greedy``,
``_accept_round``, ``speculative_generate``). A small draft model proposes
``gamma`` tokens one cached forward at a time; the target scores all of
them in one cached forward of T = gamma (one pass over its weights
instead of gamma), a speculative verify window of the ragged-paged
kernel. Greedy mode keeps the longest prefix of proposals that equals the
target's own argmax plus the target's token at the cut: the output is
target-only greedy decoding, up to float determinism (the T = gamma
verify and the T = 1 decode sum in different orders, so a bf16 near tie
can flip; in f32 the tokens are equal in practice).

Sampled mode keeps a proposal d ~ q with probability min(1, p/q) and
draws a rejection's replacement from normalize(max(p - q, 0)), so every
emitted token is distributed as the target's filtered distribution p
(the speculative sampling theorem, tested statistically on
:func:`_accept_round`). Draws come from an explicit ``torch.Generator``
as Gumbel-max (``sampling.categorical``), so a CUDA graph can replay
them: the reference's ``fold_in`` keys have no counterpart here, and the
port pins the distribution, not the draws.

Every round has fixed shapes: gamma draft steps and one verify forward;
the accepted count moves a length, and rejected rows stay in both caches
beyond it, hidden by the position mask and overwritten by later writes.
:func:`speculative_generate` loops over rounds on the host (one read of
the count a round); ``models/spec_batching.py`` runs the same round for
every slot of a batch as one CUDA graph.
"""

from __future__ import annotations

import torch

from k8s_gpu_device_plugin_torch.models.generate import KVCache, _forward_cached
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig
from k8s_gpu_device_plugin_torch.models.sampling import (
    Sampler,
    _gumbel,
    categorical,
    filtered_logits,
    filtered_probs,
    sample_logits,
)
from k8s_gpu_device_plugin_torch.ops.ragged_paged_attention import MAX_VERIFY_T


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1)


def _accept_round(
    generator: torch.Generator,
    d_toks: torch.Tensor,   # (B, gamma) draft proposals, drawn from q
    q_probs: torch.Tensor,  # (B, gamma, V) draft distributions
    p_probs: torch.Tensor,  # (B, gamma, V) target distributions
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rejection core for every row of a batch: returns (n accepted,
    bonus token, count), each (B,) int64.

    Proposal i is kept with probability min(1, p_i(d_i) / q_i(d_i)) and
    the run of kept proposals ends at the first rejection, whose
    replacement is drawn from the residual normalize(max(p - q, 0)) at
    that position (the target distribution itself where the residual
    vanishes, p == q up to rounding). A full acceptance emits gamma
    tokens and no bonus. Draws come from ``generator`` only (a (B, gamma)
    uniform block, then a (B, V) Gumbel block): no host sync."""
    b, gamma = d_toks.shape
    v = p_probs.shape[-1]
    idx = d_toks[..., None]
    qi = q_probs.gather(2, idx)[..., 0]
    pi = p_probs.gather(2, idx)[..., 0]
    u = torch.rand((b, gamma), generator=generator, device=d_toks.device)
    accepted = (u * qi < pi).long()            # u < p/q  (q > 0: d ~ q)
    n = torch.cumprod(accepted, dim=1).sum(dim=1)
    row = torch.clamp(n, max=gamma - 1)[:, None, None].expand(b, 1, v)
    p_row = p_probs.gather(1, row)[:, 0]
    residual = torch.clamp(p_row - q_probs.gather(1, row)[:, 0], min=0.0)
    total = residual.sum(dim=-1, keepdim=True)
    residual = torch.where(total > 1e-9, residual / total, p_row)
    noise = _gumbel((b, v), generator, d_toks.device)
    bonus = (torch.log(residual + 1e-38) + noise).argmax(dim=-1)
    count = torch.clamp(n + 1, max=gamma)
    return n, bonus, count


def speculative_generate(
    params_t: dict,
    cfg_t: LlamaConfig,
    params_d: dict,
    cfg_d: LlamaConfig,
    prompt: torch.Tensor,
    max_new: int,
    gamma: int = 4,
    sampler: "Sampler | None" = None,
    generator: "torch.Generator | None" = None,
) -> tuple[torch.Tensor, int]:
    """Speculative decode, greedy by default, sampled with a ``Sampler``.

    prompt: (1, P) int. Returns (tokens (1, max_new) int64, rounds): the
    number of verify forwards the target ran. The first token comes from
    the prefill, so the mean tokens a round is ``(max_new - 1) / rounds``
    (gamma for a draft that is always right).

    Greedy (``sampler`` None or temperature 0): the tokens of
    ``generate(params_t, prompt, cfg_t, max_new)``. Sampled: the
    proposals d ~ q are kept with probability min(1, p/q) and replaced
    from normalize(max(p - q, 0)), both models under the same filters,
    drawing from ``generator`` (a fresh one seeded 0 on the prompt's
    device when None)."""
    if cfg_t.quant != "none" or cfg_d.quant != "none":
        raise NotImplementedError("speculative decode is bf16-only")
    if sampler is not None and sampler.repetition_penalty > 1.0:
        # the acceptance theorem assumes fixed per-position distributions;
        # a context-dependent penalty changes p and q inside a round
        raise NotImplementedError(
            "repetition_penalty is not supported in speculative decoding"
        )
    if cfg_t.vocab_size != cfg_d.vocab_size:
        raise ValueError(
            f"draft/target vocab mismatch: {cfg_d.vocab_size} vs "
            f"{cfg_t.vocab_size}"
        )
    b, p = prompt.shape
    if b != 1:
        raise NotImplementedError(
            "speculative decode is batch-1 (per-row accepted counts would "
            "need per-row cache lengths)"
        )
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")

    device = prompt.device
    max_len = p + max_new + gamma  # slack: the last round may overshoot
    t_cache = KVCache.init(cfg_t, b, max_len, device)
    d_cache = KVCache.init(cfg_d, b, max_len, device)
    # prefill both models; the target's last position gives the first
    # token, the draft's logits are not projected past it
    t_logits = _forward_cached(params_t, prompt, t_cache, 0, cfg_t,
                               last_only=True)[:, -1]
    _forward_cached(params_d, prompt, d_cache, 0, cfg_d, last_only=True)
    greedy = sampler is None or sampler.is_greedy
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    first = (_greedy(t_logits) if greedy
             else sample_logits(t_logits, generator, sampler))
    out = [first[:, None]]
    generated, length, rounds, last = 1, p, 0, first
    idx = torch.arange(gamma, device=device)[None, :]
    while generated < max_new:
        # gamma draft steps over [last, d_1 .. d_{gamma-1}]
        tok, d_toks, q_probs = last, [], []
        for j in range(gamma):
            logits = _forward_cached(params_d, tok[:, None], d_cache,
                                     length + j, cfg_d)[:, -1]
            if greedy:
                tok = _greedy(logits)
            else:
                fl = filtered_logits(logits, sampler)
                tok = categorical(fl, generator)
                q_probs.append(torch.softmax(fl, dim=-1))
            d_toks.append(tok)
        d_toks = torch.stack(d_toks, dim=1)                    # (1, gamma)
        # the target scores them in one forward (a verify window when
        # 2 <= gamma <= MAX_VERIFY_T; the kernel takes any T)
        verify_in = torch.cat([last[:, None], d_toks[:, :-1]], dim=1)
        v_logits = _forward_cached(params_t, verify_in, t_cache, length,
                                   cfg_t, verify=1 < gamma <= MAX_VERIFY_T)
        if greedy:
            # the longest prefix equal to the target's argmax, and the
            # target's token at the cut; a full acceptance has no logits
            # past d_gamma, so it emits gamma tokens and no bonus
            pred = _greedy(v_logits)
            n = torch.cumprod((d_toks == pred).long(), dim=1).sum(dim=1)
            count = torch.clamp(n + 1, max=gamma)
            emit = torch.where(idx < n[:, None], d_toks, pred)
        else:
            p_probs = filtered_probs(v_logits, sampler)
            n, bonus, count = _accept_round(
                generator, d_toks, torch.stack(q_probs, dim=1), p_probs)
            emit = torch.where(idx < n[:, None], d_toks, bonus[:, None])
        c = int(count[0])                       # the round's one host read
        out.append(emit[:, :c])
        last = emit[:, c - 1]
        # both caches wrote rows length .. length+gamma-1 for the same
        # tokens; the rows past the accepted ones are overwritten later
        generated += c
        length += c
        rounds += 1
    return torch.cat(out, dim=1)[:, :max_new], rounds
