"""The port's speculative decoding core against the reference's
(``tests/test_speculative.py``): ``models/speculative.py``, the static
sampler's filters of ``models/sampling.py`` and the verify and decode
faces ``ops/paged_attention.py`` and ``ops/ragged_decode.py``.

- ``filtered_logits`` / ``filtered_probs`` under temperature, top-k and
  top-p: allclose to the reference's within 1e-6 (f32).
- ``_accept_round``'s marginals equal the target distribution,
  statistically, at gamma 1 and 2 (the reference's 4-sigma bound): the
  speculative sampling theorem on the port's batched core and its
  generator draws (the port cannot reproduce JAX's ``fold_in`` draws, so
  the distribution is pinned, not the tokens).
- ``speculative_generate`` greedy, on the tiny f32 config with the JAX
  weights converted: the reference's tokens and the port's ``generate``
  tokens, with a self-draft and with a draft that is the target's first
  layer with its embedding, norm and head (partial acceptance); the
  round counts the reference's, ``ceil((max_new - 1) / gamma)`` for the
  self-draft; its refusals with the reference's exception types.
- The verify window (T 2 .. 16) and the T = 1 decode faces on the CPU
  against the reference's kernel in interpret mode, within 1e-5.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import sampling as jsampling
from k8s_gpu_device_plugin_tpu.models import speculative as jspec
from k8s_gpu_device_plugin_tpu.ops import paged_attention as jpaged
from k8s_gpu_device_plugin_tpu.ops import ragged_decode as jdecode
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import sampling as tsampling
from k8s_gpu_device_plugin_torch.models import speculative as tspec
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.models.generate import generate
from k8s_gpu_device_plugin_torch.ops import paged_attention as tpaged
from k8s_gpu_device_plugin_torch.ops import ragged_decode as tdecode

torch.set_num_threads(1)

PROMPT = list(range(1, 9))


def _first_layer(params, layers=1):
    """The target's first ``layers`` layers with its embedding, final
    norm and head: the same tensors (views), no copy."""
    return {**params, "layers": {k: v[:layers]
                                 for k, v in params["layers"].items()}}


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    jd = (dataclasses.replace(jcfg, n_layers=1),
          {**jparams, "layers": jax.tree.map(lambda x: x[:1],
                                             jparams["layers"])})
    td = (dataclasses.replace(tcfg, n_layers=1), _first_layer(tparams))
    return jcfg, jparams, tcfg, tparams, jd, td


def _tprompt():
    return torch.tensor([PROMPT])


def _jprompt():
    return jnp.asarray([PROMPT], jnp.int32)


# --- the static sampler's filters -------------------------------------------


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.7), dict(temperature=0.9, top_k=20),
    dict(temperature=1.3, top_p=0.8),
    dict(temperature=0.8, top_k=50, top_p=0.95)])
def test_filtered_logits_and_probs_match_the_reference(knobs):
    logits = np.random.default_rng(3).standard_normal(
        (4, 3, 512)).astype(np.float32) * 3
    want_l = jsampling.filtered_logits(jnp.asarray(logits),
                                       jsampling.Sampler(**knobs))
    want_p = jsampling.filtered_probs(jnp.asarray(logits),
                                      jsampling.Sampler(**knobs))
    got_l = tsampling.filtered_logits(torch.from_numpy(logits),
                                      tsampling.Sampler(**knobs))
    got_p = tsampling.filtered_probs(torch.from_numpy(logits),
                                     tsampling.Sampler(**knobs))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-6,
                               rtol=0)
    # the same tokens survive the filters
    assert np.array_equal(got_l.numpy() > -1e29, np.asarray(want_l) > -1e29)


def test_sample_logits_greedy_and_in_support():
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (6, 512)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(tsampling.sample_logits(logits, gen,
                                               tsampling.Sampler()),
                       logits.argmax(-1))
    s = tsampling.Sampler(temperature=0.9, top_k=5)
    allowed = tsampling.filtered_logits(logits, s) > -1e29
    for _ in range(20):
        tok = tsampling.sample_logits(logits, gen, s)
        assert allowed.gather(1, tok[:, None]).all()
    with pytest.raises(ValueError, match="repetition_penalty"):
        tsampling.sample_logits(logits, gen,
                                tsampling.Sampler(repetition_penalty=1.2))


# --- the rejection core: the speculative sampling theorem -------------------


def _dists(seed, rows, v=8):
    rng = np.random.default_rng(seed)
    p = torch.softmax(torch.from_numpy(rng.standard_normal((rows, v))) * 1.5,
                      -1).float()
    q = torch.softmax(torch.from_numpy(rng.standard_normal((rows, v))) * 1.5,
                      -1).float()
    return p, q


def _within_4_sigma(toks, probs, trials):
    counts = np.bincount(toks, minlength=len(probs))
    expected = probs * trials
    sigma = np.sqrt(expected * (1 - probs))
    assert (np.abs(counts - expected) < 4 * sigma + 1).all(), (
        counts, expected.round(1))


def test_accept_round_marginal_is_target_distribution():
    """gamma 1: the draft proposes d ~ q, the round keeps it with
    probability min(1, p/q) or resamples from the residual: the emitted
    token's marginal over 4000 rows must be p."""
    p, q = _dists(42, 1)
    trials = 4000
    gen = torch.Generator().manual_seed(0)
    d = torch.multinomial(q.expand(trials, -1), 1, generator=gen)
    n, bonus, count = tspec._accept_round(
        gen, d, q.expand(trials, -1)[:, None], p.expand(trials, -1)[:, None])
    assert torch.equal(count, torch.ones_like(count))
    toks = torch.where(n > 0, d[:, 0], bonus).numpy()
    _within_4_sigma(toks, p[0].numpy().astype(np.float64), trials)


def test_accept_round_gamma2_marginals():
    """gamma 2: slot 0's marginal over every row must be p_0, slot 1's
    over the rows that kept proposal 0 (n >= 1) p_1: the cumprod prefix
    count, the interior residual row and the bonus slot's place."""
    p, q = _dists(7, 2)
    trials = 8000
    gen = torch.Generator().manual_seed(1)
    d = torch.stack([torch.multinomial(q[i].expand(trials, -1), 1,
                                       generator=gen)[:, 0]
                     for i in range(2)], dim=1)
    n, bonus, count = tspec._accept_round(
        gen, d, q.expand(trials, -1, -1), p.expand(trials, -1, -1))
    assert torch.equal(count, torch.clamp(n + 1, max=2))
    slot0 = torch.where(n > 0, d[:, 0], bonus).numpy()
    slot1 = torch.where(n > 1, d[:, 1], bonus)[n >= 1].numpy()
    _within_4_sigma(slot0, p[0].numpy().astype(np.float64), trials)
    assert len(slot1) > 1200
    _within_4_sigma(slot1, p[1].numpy().astype(np.float64), len(slot1))


def test_accept_round_equal_distributions_accept_everything():
    """p == q: every proposal is kept and the count is gamma."""
    p, _ = _dists(5, 3)
    gen = torch.Generator().manual_seed(2)
    d = torch.multinomial(p, 1, generator=gen)[:, 0][None].expand(64, -1)
    n, _, count = tspec._accept_round(gen, d, p.expand(64, -1, -1),
                                      p.expand(64, -1, -1))
    assert (n == 3).all() and (count == 3).all()


# --- speculative_generate ---------------------------------------------------


def test_self_draft_accepts_everything(models):
    """Draft == target: every proposal matches, each round advances
    gamma, and the tokens are plain greedy decoding (and the
    reference's)."""
    jcfg, jparams, tcfg, tparams, _, _ = models
    max_new, gamma = 13, 4
    toks, rounds = tspec.speculative_generate(
        tparams, tcfg, tparams, tcfg, _tprompt(), max_new=max_new,
        gamma=gamma)
    want, jrounds = jspec.speculative_generate(
        jparams, jcfg, jparams, jcfg, _jprompt(), max_new=max_new,
        gamma=gamma)
    assert toks.tolist() == np.asarray(want).tolist()
    assert torch.equal(toks, generate(tparams, _tprompt(), tcfg, max_new))
    assert rounds == int(jrounds) == -(-(max_new - 1) // gamma)


def test_weak_draft_is_still_lossless(models):
    """The target's first layer as the draft proposes many wrong tokens:
    the output is still target-only greedy decoding, in as many rounds
    as the reference's."""
    jcfg, jparams, tcfg, tparams, (jdcfg, jdparams), (tdcfg, tdparams) = \
        models
    max_new, gamma = 12, 3
    toks, rounds = tspec.speculative_generate(
        tparams, tcfg, tdparams, tdcfg, _tprompt(), max_new=max_new,
        gamma=gamma)
    want, jrounds = jspec.speculative_generate(
        jparams, jcfg, jdparams, jdcfg, _jprompt(), max_new=max_new,
        gamma=gamma)
    assert toks.tolist() == np.asarray(want).tolist()
    assert torch.equal(toks, generate(tparams, _tprompt(), tcfg, max_new))
    assert rounds == int(jrounds)
    # a draft that is sometimes wrong costs more rounds than a perfect one
    assert -(-(max_new - 1) // gamma) < rounds <= max_new - 1


def test_single_token_needs_no_rounds(models):
    _, _, tcfg, tparams, _, _ = models
    toks, rounds = tspec.speculative_generate(
        tparams, tcfg, tparams, tcfg, _tprompt(), max_new=1)
    assert torch.equal(toks, generate(tparams, _tprompt(), tcfg, 1))
    assert rounds == 0


def test_validation(models):
    _, _, tcfg, tparams, _, _ = models
    cfg_v = tllama.LlamaConfig.tiny(dtype=torch.float32, vocab_size=256)
    params_v = tllama.init_params(cfg_v, seed=1, device="cpu")
    with pytest.raises(ValueError, match="vocab mismatch"):
        tspec.speculative_generate(tparams, tcfg, params_v, cfg_v,
                                   _tprompt(), max_new=4)
    with pytest.raises(NotImplementedError, match="batch-1"):
        tspec.speculative_generate(tparams, tcfg, tparams, tcfg,
                                   torch.zeros((2, 8), dtype=torch.long),
                                   max_new=4)
    # an int8-trained config decodes with other numerics than its
    # training forward: refused here, as the reference refuses it
    cfg_q = copy.copy(tcfg)
    object.__setattr__(cfg_q, "quant", "int8")
    with pytest.raises(NotImplementedError, match="bf16-only"):
        tspec.speculative_generate(tparams, cfg_q, tparams, tcfg,
                                   _tprompt(), max_new=4)
    with pytest.raises(NotImplementedError, match="repetition_penalty"):
        tspec.speculative_generate(
            tparams, tcfg, tparams, tcfg, _tprompt(), max_new=4,
            sampler=tsampling.Sampler(temperature=0.7,
                                      repetition_penalty=1.2))
    with pytest.raises(ValueError, match="max_new"):
        tspec.speculative_generate(tparams, tcfg, tparams, tcfg,
                                   _tprompt(), max_new=0)


def test_sampled_self_draft_accepts_everything(models):
    """Draft == target: p == q, so every proposal is kept (one stray
    rejection allowed for rounding, as the reference allows)."""
    _, _, tcfg, tparams, _, _ = models
    max_new, gamma = 13, 4
    toks, rounds = tspec.speculative_generate(
        tparams, tcfg, tparams, tcfg, _tprompt(), max_new=max_new,
        gamma=gamma, sampler=tsampling.Sampler(temperature=0.9),
        generator=torch.Generator().manual_seed(5))
    assert toks.shape == (1, max_new)
    floor = -(-(max_new - 1) // gamma)
    assert floor <= rounds <= floor + 1


def test_sampled_with_filters_runs_and_stays_in_vocab(models):
    _, _, tcfg, tparams, _, (tdcfg, tdparams) = models
    toks, rounds = tspec.speculative_generate(
        tparams, tcfg, tdparams, tdcfg, _tprompt(), max_new=10, gamma=3,
        sampler=tsampling.Sampler(temperature=0.8, top_k=20, top_p=0.95),
        generator=torch.Generator().manual_seed(11))
    a = toks.numpy()
    assert a.shape == (1, 10)
    assert (a >= 0).all() and (a < tcfg.vocab_size).all()
    assert 1 <= rounds <= 9


# --- the verify and decode faces --------------------------------------------

HD, PS, N_PAGES, NPG = 64, 8, 16, 4


def _pool_inputs(t, b=3, hq=8, hkv=2, seed=1):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((N_PAGES, PS, hkv, HD)).astype(np.float32)
    vp = rng.standard_normal((N_PAGES, PS, hkv, HD)).astype(np.float32)
    q = rng.standard_normal((b, t, hq, HD)).astype(np.float32)
    table = rng.choice(np.arange(1, N_PAGES), (b, NPG),
                       replace=False).astype(np.int32)
    return q, kp, vp, table


@pytest.mark.parametrize("t", [2, 4, 8, 16])
def test_paged_verify_attention_matches_the_reference(t):
    """Each slot's window at its own base (the causal stagger), through a
    shuffled table, windowed and not."""
    q, kp, vp, table = _pool_inputs(t)
    base = np.asarray([0, 9, NPG * PS - t], np.int32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, kp, vp))
    ttab, tbase = torch.from_numpy(table), torch.from_numpy(base)
    assert tpaged.supports_verify(tq, tk, ttab)
    assert not tpaged.supports(tq, tk, ttab)
    for window in (0, 12):
        want = jpaged.paged_verify_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(base), scale=HD ** -0.5,
            window=window, interpret=True)
        got = tpaged.paged_verify_attention(tq, tk, tv, ttab, tbase,
                                            scale=HD ** -0.5, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


def test_paged_decode_and_ragged_decode_match_the_reference():
    q, kp, vp, table = _pool_inputs(1)
    lengths = np.asarray([1, 17, NPG * PS], np.int32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, kp, vp))
    ttab, tlen = torch.from_numpy(table), torch.from_numpy(lengths)
    assert tpaged.supports(tq, tk, ttab)
    assert not tpaged.supports_verify(tq, tk, ttab)
    want = jpaged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), scale=HD ** -0.5, interpret=True)
    got = tpaged.paged_decode_attention(tq, tk, tv, ttab, tlen,
                                        scale=HD ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # the dense face: the pool gathered into (B, S, Hkv, hd) rows
    kd, vd = (np.ascontiguousarray(x[table].reshape(3, NPG * PS, 2, HD))
              for x in (kp, vp))
    assert tdecode.supports(tq, torch.from_numpy(kd))
    for window in (0, 12):
        want = jdecode.ragged_decode_attention(
            jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd),
            jnp.asarray(lengths), scale=HD ** -0.5, window=window,
            block_k=32, interpret=True)
        got = tdecode.ragged_decode_attention(
            tq, torch.from_numpy(kd), torch.from_numpy(vd), tlen,
            scale=HD ** -0.5, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


def test_shape_gates_match_the_reference():
    """T = 1 belongs to decode, a 32-row window to the prefill chunks, a
    page of 12 rows to nobody: the reference's gates, on the port's
    faces (hd 64, a group of 4)."""
    q, kp, _, table = _pool_inputs(4)
    tk, ttab = torch.from_numpy(kp), torch.from_numpy(table)
    for t, want in ((1, False), (2, True), (16, True), (17, False),
                    (32, False)):
        qq = torch.zeros((3, t, 8, HD))
        assert tpaged.supports_verify(qq, tk, ttab) == want, t
        assert jpaged.supports_verify(
            jnp.zeros((3, t, 8, HD)), jnp.asarray(kp), jnp.asarray(table),
            require_pltpu=False) == want, t
    odd = torch.zeros((N_PAGES, 12, 2, HD))
    assert not tpaged.supports_verify(torch.from_numpy(q), odd, ttab)
    with pytest.raises(ValueError, match="verify window"):
        tpaged.paged_verify_attention(torch.zeros((3, 1, 8, HD)), tk, tk,
                                      ttab, torch.zeros(3, dtype=torch.int32),
                                      scale=1.0)
